"""One run of one benchmark cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed on the card, the program built and every shape
of the cell warmed), then a window of ``--seconds``, then the check of what
the window produced against the plain reference. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each compared number beside its limit); the compared numbers are
also the last lines of standard error. With ``--trace 0`` the metrics are
the cell's end-to-end ones, with ``--trace 1`` its per-layer ones.

No result is printed, and the exit code is not 0, without a CUDA device (or
with fewer than the cell asks for), or when JAX or the JAX package has been
imported into this process.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    keep optional libraries from loading JAX."""
    build = os.path.join(_ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor_cache")
    for key in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[key] = "0"


_cache_env()

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_flamingo_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc; the module's import
    time where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the JAX one's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _checks_line(checks) -> dict:
    return {name: {"value": value, "limit": limit} for name, value, limit in checks}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             bench=None, config=None, control=None, units: int = 0) -> dict:
    """Set up, measure and check one cell; returns the result object. The
    chip checks are the caller's (tests run this on the CPU at small sizes
    through ``config``). ``control="fp8"`` runs the control, the reference
    in fp8 in the program's place; ``units`` > 0 ends the window after that
    many units, not ``seconds``."""
    import torch

    from . import spec
    from .trace import Recorder

    bench = bench or spec.benchmark()
    w = spec.workload(bench, cell)
    cfg = config or spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    limits = spec.limits(cell)
    rec = Recorder(trace, device)
    drv = spec.driver(traffic["driver"]).Driver(cfg, traffic, seed, rec, device, control=control,
                                                 seconds=seconds, units=units)
    drv.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = process_age_s()
    stats = drv.run_window()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the benchmark process: {found}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    drv.release()
    checks = drv.check(limits)
    correct = all(value <= limit for _, value, limit in checks) and stats["failed"] == 0
    out = {"correct": bool(correct), "attempted": stats["attempted"], "failed": stats["failed"]}
    metrics = {}
    if not trace:
        e2e = dict(stats["e2e"], setup_s=setup_s)
        for m in spec.end_to_end(bench, cell):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        from .readings import Readings

        r = Readings(rec, stats)
        for m in spec.per_layer(bench, cell):
            value = spec.reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        busy, window = rec.events.busy_window_s()
        dev.update(busy_s=busy, window_s=window)
        out["breakdown"] = rec.events.breakdown()
        stats.setdefault("notes", {}).update(
            traced_e2e=stats["e2e"], device_ops=len(rec.events.device),
            unlinked_ops=rec.events.unlinked, range_device_s=rec.events.by_range())
    out["device"] = dev
    out["checks"] = _checks_line(checks)
    out["_notes"] = dict(stats.get("notes", {}), **(drv.notes() if hasattr(drv, "notes") else {}))
    return out


def result_line(out: dict) -> str:
    """The result's JSON line: the contract's keys, ``checks`` last."""
    keys = ["correct", "attempted", "failed", "metrics", "device", "breakdown"]
    line = {k: out[k] for k in keys if k in out}
    line["checks"] = out["checks"]
    return json.dumps(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    bench = spec.benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    notes = out.pop("_notes")
    if notes:
        print(json.dumps({"notes": notes}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
