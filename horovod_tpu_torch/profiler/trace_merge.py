"""Merge Chrome-trace JSON event lists into one Perfetto-loadable trace.

Counterpart of the JSON-merging half of ``horovod_tpu/profiler/
trace_merge.py``, copied: a list of Chrome-trace events (the serving
plane's request spans, or an engine-style timeline file) is moved into a
process group of its own (integer lanes with ``thread_name`` metadata,
timestamps optionally shifted) and merged with a second Chrome trace given
as a dict, an event list or a ``.json``/``.json.gz`` file. The reference's
other input, the JAX profiler's log directory, has a torch-profiler
counterpart still to port.
"""

from __future__ import annotations

import gzip
import io
import json
import os
from typing import Iterable, List, Optional, Union

TraceLike = Union[str, os.PathLike, dict, list, None]

# Engine lanes get their own pid, far from real host pids.
DEFAULT_ENGINE_PID = 90210


def _read_text(path: str) -> str:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
            return f.read()
    with io.open(path, "r", encoding="utf-8", errors="replace") as f:
        return f.read()


def load_engine_timeline(path: Union[str, os.PathLike]) -> List[dict]:
    """Parse a Chrome-trace JSON array, tolerating a missing closing
    bracket (a killed writer never closes it) and a trailing comma."""
    text = _read_text(str(path)).strip()
    if not text:
        return []
    try:
        events = json.loads(text)
    except json.JSONDecodeError:
        # A killed writer can stop anywhere: after a record + comma, or
        # mid-record. Truncate at the end of the last COMPLETE record
        # (events are flat objects, so their closing brace is the last
        # '}'), drop the partial tail, and close the array.
        cut = text.rfind("}")
        if cut < 0:
            return []
        fixed = text[:cut + 1].rstrip().rstrip(",")
        if not fixed.endswith("]"):
            fixed += "]"
        events = json.loads(fixed)
    if not isinstance(events, list):
        raise ValueError(f"engine timeline {path} is not a JSON array")
    return [e for e in events if isinstance(e, dict)]


def _load_trace_events(trace: TraceLike) -> List[dict]:
    """Events from a Chrome-trace object or array, or a path to one
    (.json or .json.gz)."""
    if trace is None:
        return []
    if isinstance(trace, dict):
        return list(trace.get("traceEvents", []))
    if isinstance(trace, list):
        return list(trace)
    data = json.loads(_read_text(str(trace)))
    if isinstance(data, dict):
        return list(data.get("traceEvents", []))
    return list(data) if isinstance(data, list) else []


def _meta(pid: int, tid: int, name: str, value: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": name,
            "args": {"name": value}}


def _rewrite_engine_events(events: Iterable[dict], engine_pid: int,
                           engine_label: str,
                           offset_us: float) -> List[dict]:
    """Move events into their own process group: integer tids (one per
    lane, Perfetto wants ints) + thread_name metadata carrying the original
    lane name, pid remapped, timestamps shifted."""
    out: List[dict] = [_meta(engine_pid, 0, "process_name", engine_label)]
    tid_of: dict = {}
    for e in events:
        lane = str(e.get("tid", ""))
        tid = tid_of.get(lane)
        if tid is None:
            tid = len(tid_of) + 1
            tid_of[lane] = tid
            out.append(_meta(engine_pid, tid, "thread_name", lane))
        ev = dict(e)
        ev["pid"] = engine_pid
        ev["tid"] = tid
        if offset_us:
            ev["ts"] = float(ev.get("ts", 0)) + offset_us
        out.append(ev)
    return out


def merge_traces(engine_timeline: TraceLike,
                 trace: TraceLike = None,
                 out_path: Optional[Union[str, os.PathLike]] = None,
                 *,
                 engine_pid: int = DEFAULT_ENGINE_PID,
                 engine_label: str = "horovod engine",
                 offset_us: float = 0.0) -> dict:
    """One Perfetto-compatible Chrome trace of both inputs.

    ``engine_timeline``: a path to a Chrome-trace JSON array, or the events
    themselves; they get the process group ``engine_pid``. ``trace``: a
    second Chrome trace (dict, event list or file path), merged as it is.
    Returns the merged trace dict; writes it to ``out_path`` when given
    (gzipped iff it ends in ``.gz``)."""
    if isinstance(engine_timeline, (str, os.PathLike)):
        engine_events = load_engine_timeline(engine_timeline)
    elif isinstance(engine_timeline, dict):
        engine_events = list(engine_timeline.get("traceEvents", []))
    else:
        engine_events = list(engine_timeline or [])

    merged = _rewrite_engine_events(engine_events, engine_pid, engine_label,
                                    offset_us)
    merged += _load_trace_events(trace)
    out = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "producer": "horovod_tpu_torch.profiler.trace_merge",
            "engine_pid": engine_pid,
            "engine_offset_us": offset_us,
        },
    }
    if out_path is not None:
        out_path = str(out_path)
        payload = json.dumps(out)
        if out_path.endswith(".gz"):
            with gzip.open(out_path, "wt", encoding="utf-8") as f:
                f.write(payload)
        else:
            with io.open(out_path, "w", encoding="utf-8") as f:
                f.write(payload)
    return out
