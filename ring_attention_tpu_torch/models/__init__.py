"""Model layers of the single-device serving path."""

from .attention import RingAttention
from .layers import FeedForward, RMSNorm
from .remat import REMAT_POLICIES, resolve_remat_policy
from .transformer import RingTransformer

__all__ = ["FeedForward", "REMAT_POLICIES", "RMSNorm", "RingAttention", "RingTransformer",
           "resolve_remat_policy"]
