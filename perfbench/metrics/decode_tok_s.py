"""decode_tok_s (tokens/s): decode tokens the engine committed in the window
over its seconds."""
from perfbench.readers import decode_tok_s as read  # noqa: F401
