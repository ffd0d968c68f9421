"""The program's own spans and counters (`fsw_gnn_tpu_torch.utils.
profiling`), for the readers of the `program_span` and `program_counter`
metrics: the instance this process loaded, read after the window.
A program without the recorder gives no spans and no counters, so those
readers find nothing to read there and return None."""
from __future__ import annotations


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from fsw_gnn_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, 'spans') and hasattr(profiling, 'counters')):
        return None
    return profiling


def spans() -> list:
    rec = recorder()
    return rec.spans() if rec is not None else []


def counters() -> dict:
    rec = recorder()
    return rec.counters() if rec is not None else {}


def seconds(s) -> float:
    return 1e-9 * (s.t1_ns - s.t0_ns)


def inside(inner, outer) -> bool:
    return outer.t0_ns <= inner.t0_ns and inner.t1_ns <= outer.t1_ns
