"""Batched parameter optimizers (NFT) over the fold and slot kernels."""

from queasars_tpu_torch.optim.nft import BatchedNFT, NFTConfig

__all__ = ["BatchedNFT", "NFTConfig"]
