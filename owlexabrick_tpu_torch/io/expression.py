"""Vectorized postfix expression evaluator for derived scalar fields (the
port's copy of ``owlexabrick_tpu/io/expression.py``, host numpy).

The reference evaluates postfix expressions per cell on CPU threads
(exa/ScalarField.cpp:98-227).  Here the whole field is evaluated with
numpy array ops in one pass — same tokens, same semantics:

  * ``%i``          — push field i's per-cell values
  * ``+ - * / **``  — arithmetic (``**`` = pow)
  * ``== != < > <= >=`` — comparisons (pushed as 0.0/1.0)
  * ``select``      — ternary: mask op1 op2 select -> mask ? op1 : op2
  * ``log abs sqrt``— unary
  * anything else   — float constant
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_BINARY = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": np.divide,
    "**": np.power,
    "==": lambda a, b: (a == b).astype(np.float32),
    "!=": lambda a, b: (a != b).astype(np.float32),
    "<": lambda a, b: (a < b).astype(np.float32),
    ">": lambda a, b: (a > b).astype(np.float32),
    "<=": lambda a, b: (a <= b).astype(np.float32),
    ">=": lambda a, b: (a >= b).astype(np.float32),
}

_UNARY = {
    "log": np.log,
    "abs": np.abs,
    "sqrt": np.sqrt,
}


def evaluate_postfix(tokens: Sequence[str], fields: Sequence[np.ndarray]) -> np.ndarray:
    """Evaluate a postfix expression over per-cell field arrays."""
    trimmed = [t.strip().strip('"').strip() for t in tokens]
    trimmed = [t for t in trimmed if t]
    if not trimmed:
        raise ValueError("empty expression")
    stack: List[np.ndarray] = []
    for tok in trimmed:
        if tok.startswith("%"):
            idx = int(tok[1:])
            if idx >= len(fields):
                raise ValueError(f"invalid placeholder token: {tok}")
            stack.append(np.asarray(fields[idx], dtype=np.float32))
        elif tok == "select":
            if len(stack) < 3:
                raise ValueError("insufficient operands for select")
            op2 = stack.pop()
            op1 = stack.pop()
            mask = stack.pop()
            stack.append(np.where(mask != 0, op1, op2).astype(np.float32))
        elif tok in _BINARY:
            if len(stack) < 2:
                raise ValueError(f"insufficient operands for token: {tok}")
            op2 = stack.pop()
            op1 = stack.pop()
            with np.errstate(all="ignore"):
                stack.append(_BINARY[tok](op1, op2).astype(np.float32))
        elif tok in _UNARY:
            if len(stack) < 1:
                raise ValueError(f"insufficient operands for token: {tok}")
            op = stack.pop()
            with np.errstate(all="ignore"):
                stack.append(_UNARY[tok](op).astype(np.float32))
        else:
            stack.append(np.float32(float(tok)))
    if len(stack) != 1:
        raise ValueError("invalid expression (stack depth != 1 at end)")
    result = np.asarray(stack[0], dtype=np.float32)
    if result.ndim == 0:
        n = len(fields[0]) if len(fields) else 1
        result = np.full(n, float(result), dtype=np.float32)
    return result
