"""Scripts of the repository: ``python3 tools/<name>.py`` from its root."""
