"""Model layers of the single-device serving path."""

from .attention import RingAttention
from .layers import FeedForward, RMSNorm
from .transformer import RingTransformer

__all__ = ["FeedForward", "RMSNorm", "RingAttention", "RingTransformer"]
