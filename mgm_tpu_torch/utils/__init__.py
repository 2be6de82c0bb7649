from .profiling import trace, timed
from .checkpoint import save_state, load_state
