"""decode_attn_roofline.backlog (%), decode attention: over the traced
sub-window, the least time of the decode calls made (bytes at the
bandwidth or operations at the cache dtype's rate) over those kernels'
device time."""
from perfbench.readers import decode_attn_roofline as read  # noqa: F401
