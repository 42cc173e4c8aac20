"""Library output sink (reference AMGX_register_print_callback,
amgx_c.h:189-191): all solver and grid output goes through emit(), so
a host code can capture it (the JAX package's ``core/printing.py``)."""

from __future__ import annotations

_sink = [None]


def set_print_callback(fn):
    """fn(text: str) -> None; None restores stdout."""
    _sink[0] = fn


def emit(text: str):
    fn = _sink[0]
    if fn is None:
        print(text)
    else:
        fn(text + "\n")
