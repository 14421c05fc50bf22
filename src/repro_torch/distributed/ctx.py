"""Thread-local sharding rules.

The port's share of ``repro/distributed/ctx.py``: the active rule set
(``current_rules``) and the context manager that installs one
(``sharding_rules``).  The model layer reads the rules when it lays out and
writes a KV cache; the dispatch layer reads them to pick the
context-parallel decode.  The JAX module also folds the rule set into a
trace token, because a jitted function would otherwise replay a trace made
under other rules; eager PyTorch keeps no trace cache, so the port needs
no token.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[dict]):
    """Install ``rules`` (e.g. ``sharding.decode_rules(...)``; None clears
    them) for the body of the ``with``."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev
