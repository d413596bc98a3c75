"""Plain PyTorch oracle of the whole SpMV (the semantics every variant matches)."""
from __future__ import annotations

import torch

__all__ = ["spmv_coo_ref"]


def spmv_coo_ref(n_rows: int, rows, cols, vals, x) -> torch.Tensor:
    """y = A @ x for COO A, summed in COO order."""
    rows, cols = torch.as_tensor(rows).long(), torch.as_tensor(cols).long()
    vals = torch.as_tensor(vals)
    x = torch.as_tensor(x, device=vals.device)
    y = torch.zeros(n_rows, dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, rows.to(vals.device), vals * x[cols.to(vals.device)])
