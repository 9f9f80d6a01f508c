"""Structured logging and profiling hooks (port of
premvos_tpu/utils/logging.py): one stdlib logger, a stage timer that waits
for the device, and `torch.profiler` trace annotations."""

from __future__ import annotations

import contextlib
import json
import logging
import time

import torch

_logger = None


def get_logger(name: str = "premvos", logfile=None) -> logging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    log.addHandler(sh)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        log.addHandler(fh)
    _logger = log
    return log


def _synchronize(out) -> None:
    """Wait for the CUDA devices holding any tensor in `out` (a tensor, or
    a list, tuple or dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _synchronize(v)


@contextlib.contextmanager
def stage_timer(name: str, results: dict | None = None):
    """Wall-clock a device computation: the caller puts its output tensors
    in the yielded dict under "out", and the timer waits for their device
    before it reads the clock."""
    holder = {}
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if "out" in holder:
            _synchronize(holder["out"])
        dt = time.perf_counter() - t0
        if results is not None:
            results[name] = results.get(name, 0.0) + dt
        get_logger().info("stage %s: %.1f ms", name, dt * 1000)


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in torch.profiler traces."""
    with torch.profiler.record_function(name):
        yield


def log_json(**kv):
    get_logger().info(json.dumps(kv))
