from .countsketch import countsketch_scatter
from .ops import countsketch
from .ref import countsketch_ref

__all__ = ["countsketch", "countsketch_ref", "countsketch_scatter"]
