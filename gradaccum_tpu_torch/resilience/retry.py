"""Bounded retry-with-backoff for transient IO (the port of
``gradaccum_tpu/resilience/retry.py``).

A single transient ``OSError`` on a checkpoint write must not kill a
training run that holds hours of optimizer state. :func:`retry_io` retries
the operation with exponential backoff and re-raises the LAST error once
attempts are exhausted — callers see the real failure, not a wrapper.

Only ``retry_on`` exceptions (default ``OSError``) are retried:
:class:`~gradaccum_tpu_torch.resilience.faults.InjectedCrash` is a
RuntimeError precisely so simulated process death punches straight through
this loop the way a real SIGKILL would.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple, Type, TypeVar

T = TypeVar("T")


def retry_io(
    fn: Callable[[], T],
    attempts: int = 3,
    base_delay: float = 0.05,
    backoff: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    give_up_on: Tuple[Type[BaseException], ...] = (),
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``fn`` up to ``attempts`` times; sleep ``base_delay * backoff**i``
    between failures. Returns ``fn()``'s value; re-raises the last error.
    ``give_up_on`` names ``retry_on`` subclasses that are NOT transient
    (e.g. FileNotFoundError for a read): they re-raise immediately."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delay = base_delay
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if isinstance(e, give_up_on) or attempt == attempts - 1:
                raise
            sleep(delay)
            delay *= backoff
    raise AssertionError("unreachable")
