from .jl_rademacher import jl_rademacher
from .ops import jl_project
from .ref import jl_ref, jl_row_seeds, jl_rows_ref, jl_signs_ref

__all__ = ["jl_project", "jl_rademacher", "jl_ref", "jl_row_seeds",
           "jl_rows_ref", "jl_signs_ref"]
