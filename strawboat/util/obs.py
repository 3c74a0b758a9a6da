"""Observability: codec-choice logging + device profiler helpers.

Mirrors the reference's ``log`` statements at codec-choice and ratio points
(integer/mod.rs:44-47, 65-68, 288-293 and the per-family equivalents), and
adds the device-side tracing the SURVEY calls for (§5): a ``jax.profiler``
context that dumps a trace viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import logging

log = logging.getLogger("strawboat")


def log_codec_choice(family: str, codec) -> None:
    """reference: log::info!("choose {family} compression : {codec:?}")."""
    if log.isEnabledFor(logging.INFO):
        log.info("choose %s compression : %s", family, getattr(codec, "name", codec))


def log_compress_ratio(family: str, total_bytes: int, compressed: int) -> None:
    if log.isEnabledFor(logging.DEBUG) and compressed:
        log.debug("%s compress ratio %s", family, total_bytes / compressed)


@contextlib.contextmanager
def device_trace(logdir: str = "/tmp/strawboat_trace"):
    """Profile a device region: ``with device_trace(): run_query()``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
