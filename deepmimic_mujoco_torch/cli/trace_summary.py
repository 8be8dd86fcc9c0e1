#!/usr/bin/env python3
"""Distill a ``torch.profiler`` chrome trace (``*.trace.json.gz``, as
``utils/profiling.device_trace`` writes it) into a per-kernel time table
(port of the JAX package's ``tools/trace_summary.py``).

    python -m deepmimic_mujoco_torch.cli.trace_summary /tmp/dmtpu_trace \\
        --out trace_summary.json

Reads the newest ``*.trace.json.gz`` under the directory, streaming its
events without building the parsed event list.  The device's events are
the complete events (``"ph": "X"``) whose ``cat`` is ``kernel``,
``gpu_memcpy`` or ``gpu_memset``; they are summed by name, then grouped
into categories of CUDA kernel names: ``apgd`` (the kernels of
``ops/csrc/apgd.cu`` and ``apgd_wide.cu``), ``gemm``, ``sort/topk``,
``rng``, ``copy/memset``, ``index/gather/scatter``, ``reduce``,
``elementwise``, ``other``.  A trace of work on the CPU alone holds no
device event, and the summary says so."""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def iter_events(path: str):
    """Yield trace events from a chrome-trace .json.gz without building the
    full event list (decode one object at a time)."""
    with gzip.open(path, "rt") as f:
        buf = f.read()  # the string itself is the only big allocation
    start = buf.find('"traceEvents"')
    start = buf.find("[", start) + 1
    dec = json.JSONDecoder()
    n = len(buf)
    i = start
    while i < n:
        while i < n and buf[i] in ", \n\r\t":
            i += 1
        if i >= n or buf[i] == "]":
            break
        try:
            obj, end = dec.raw_decode(buf, i)
        except json.JSONDecodeError:
            break
        yield obj
        i = end


# the first pattern that matches a kernel's name gives its category; the
# order matters: an RNG or a copy kernel is also an "elementwise_kernel"
_CATEGORIES = [
    ("apgd", re.compile(r"(?<!\w)apgd_(wide_)?kernel(?!\w)")),
    ("gemm", re.compile(r"gemm|gemv|cutlass|cublas|nvjet|xmma", re.I)),
    ("sort/topk", re.compile(r"sort|topk|radix|bitonic", re.I)),
    ("rng", re.compile(r"philox|curand|distribution_|random", re.I)),
    ("copy/memset", re.compile(r"^memcpy|^memset|copy_kernel|CatArray|"
                               r"FillFunctor", re.I)),
    ("index/gather/scatter", re.compile(r"index|gather|scatter|take|masked",
                                        re.I)),
    ("reduce", re.compile(r"reduce|norm_kernel|softmax", re.I)),
    ("elementwise", re.compile(r"elementwise|foreach|pointwise", re.I)),
]


def categorize(name: str) -> str:
    for cat, pat in _CATEGORIES:
        if pat.search(name):
            return cat
    return "other"


def find_trace(trace_dir: str) -> str:
    """The newest ``*.trace.json.gz`` under ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def summarize(path: str, top: int | None = 40) -> dict:
    """The summary of one trace: JAX's keys, and ``by_category_count``
    (device events per category, over every kernel name); ``top`` None
    lists every kernel name in ``top_ops``."""
    pid_names = {}
    device_pids = set()
    by_name = collections.Counter()
    count_by_name = collections.Counter()
    total_us = 0.0
    span_min, span_max = float("inf"), 0.0
    n_events = 0
    for ev in iter_events(path):
        ph = ev.get("ph")
        if ph == "M" and ev.get("name") == "process_name":
            pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "")
        elif ph == "X" and ev.get("cat") in DEVICE_CATS:
            device_pids.add(ev.get("pid"))
            dur = float(ev.get("dur", 0.0))
            name = ev.get("name", "?")
            by_name[name] += dur
            count_by_name[name] += 1
            total_us += dur
            ts = float(ev.get("ts", 0.0))
            span_min = min(span_min, ts)
            span_max = max(span_max, ts + dur)
            n_events += 1

    by_cat = collections.Counter()
    count_by_cat = collections.Counter()
    for name, dur in by_name.items():
        by_cat[categorize(name)] += dur
        count_by_cat[categorize(name)] += count_by_name[name]
    return {
        "trace": os.path.relpath(path),
        "device_tracks": sorted(str(pid_names.get(p, p))
                                for p in device_pids),
        "n_events": n_events,
        "busy_ms": round(total_us / 1e3, 2),
        "span_ms": round((span_max - span_min) / 1e3, 2)
        if n_events else 0.0,
        "by_category_ms": {k: round(v / 1e3, 2)
                           for k, v in by_cat.most_common()},
        "by_category_count": dict(count_by_cat),
        "top_ops": [
            {"name": n, "total_ms": round(d / 1e3, 3),
             "count": count_by_name[n],
             "mean_us": round(d / max(count_by_name[n], 1), 2)}
            for n, d in by_name.most_common(top)
        ],
    }


def report(summary: dict) -> None:
    if not summary["n_events"]:
        print(f"no device events ({', '.join(DEVICE_CATS)}) in "
              f"{summary['trace']}: the traced work ran on the CPU alone")
        return
    print(f"busy {summary['busy_ms']} ms over span {summary['span_ms']} ms "
          f"({summary['n_events']} events)")
    for k, v in summary["by_category_ms"].items():
        print(f"  {k:>22}: {v:>10.2f} ms")
    for row in summary["top_ops"][:15]:
        print(f"  {row['total_ms']:>9.2f} ms  ×{row['count']:<7d} "
              f"{row['mean_us']:>8.2f} us  {row['name'][:70]}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("trace_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args(argv)

    try:
        path = find_trace(args.trace_dir)
    except FileNotFoundError as e:
        sys.exit(str(e))
    summary = summarize(path, args.top)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(summary, indent=1) + "\n")
        print(f"wrote {args.out}")
    report(summary)
    return summary


if __name__ == "__main__":
    main()
