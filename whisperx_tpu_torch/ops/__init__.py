"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

import contextlib
import os
import threading

from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

_COUNT_LOCK = threading.Lock()
_CAPTURING = threading.local()  # .launches: the record of a capture on this thread


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to ``fn.<attr>``, a kernel's launch count. Under a lock: the
    wrappers run from several threads at once when serving, and a bare
    ``+= 1`` there may lose an update. Inside ``recording_launches`` on this
    thread (a CUDA graph capture, which launches nothing) the launch goes
    to the capture's record instead: each replay of the graph adds it with
    ``add_launches``."""
    record = getattr(_CAPTURING, "launches", None)
    if record is not None:
        record[(fn, attr)] = record.get((fn, attr), 0) + 1
        return
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


def count_pass(counter: str) -> None:
    """Add one to the tracker's counter ``counter`` (``GLOBAL_TRACKER``). As
    with ``count_launch``, inside ``recording_launches`` on this thread it
    goes to the capture's record under its name, and each replay adds it."""
    record = getattr(_CAPTURING, "launches", None)
    if record is not None:
        record[counter] = record.get(counter, 0) + 1
        return
    GLOBAL_TRACKER.add(counter)


@contextlib.contextmanager
def recording_launches():
    """Inside, on this thread: the wrappers' launches are recorded in the
    yielded dict, ``(fn, attr) → n``, and not counted; so are the tracker's
    counters of ``count_pass``, ``name → n``."""
    record = {}
    _CAPTURING.launches = record
    try:
        yield record
    finally:
        _CAPTURING.launches = None


def add_launches(record: dict) -> None:
    """Count the launches of a ``recording_launches`` record once more, under
    the counters' lock, and its tracker counters: one replay of the captured
    graph."""
    with _COUNT_LOCK:
        for key, n in record.items():
            if not isinstance(key, str):
                fn, attr = key
                setattr(fn, attr, getattr(fn, attr) + n)
    for key, n in record.items():
        if isinstance(key, str):
            GLOBAL_TRACKER.add(key, n)


def refuse_xla_route(switch: str, asked: bool, tensor) -> None:
    """The JAX package's ``WHISPERX_TPU_FLASH=0`` and
    ``WHISPERX_TPU_NO_PALLAS_QUANT`` send its work to XLA instead of the
    Pallas kernel. The port has no such route: a CUDA tensor launches the
    kernel or raises. So on a CUDA tensor the switch raises; on a CPU
    tensor, which runs the kernel's plain version anyway, it changes
    nothing."""
    if asked and tensor.is_cuda:
        raise ValueError(
            f"{switch}={os.environ.get(switch)!r} asks for the JAX package's "
            "XLA route instead of the kernel; the port has none: a CUDA tensor "
            "launches the hand-written kernel or raises (ROADMAP.md, "
            "\"Kernels\"). Unset it, or run on the CPU."
        )
