"""The benchmark of the PyTorch and CUDA port, ``crimac_unet_tpu_torch``.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  The
cell's configuration, traffic and metrics are found by name:
``BENCHMARK.json`` lists the cells and metrics,
``benchmark/workloads/<cell>.json`` holds a cell's traffic and the limits
of its check, ``benchmark/configs/<config>.json`` the frozen preset,
``benchmark/architectures/<name>.py`` the adapter of the architecture the
preset names (``unet`` where it names none: its docstring holds the
contract), and ``benchmark/metrics/<metric>.py`` the reader of a
per-layer metric.

The run makes its inputs and weights from ``--seed``, warms up, measures
for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or
profiles a short window (``--trace 1``: its per-layer metrics), checks
what the timed path produced against the plain reference in
``benchmark/reference``, and prints one JSON line last on standard
output.  Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(ROOT, "build", "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "crimac_unet_tpu")
KEEP_INPUT_SETS = 7


def _cache_env():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels into ``.kernel_build/`` there)."""
    cache = os.path.join(WORK, "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(bench, name, root=ROOT):
    """(workload entry, config entry, workload file, config file) of a
    cell, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    entry = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(os.path.join(root, "benchmark", "workloads",
                           name + ".json")) as f:
        work = json.load(f)
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    return entry, conf, work, cfg


def metrics_of(bench, name, trace):
    """The metric entries a run of cell ``name`` reports."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def _load_file(path, module_name):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric, root=ROOT):
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    return _load_file(path, "bench_metric_" + metric.replace(".", "_")).read


def load_architecture(cfg, root=ROOT):
    """The adapter module of the architecture ``cfg`` names."""
    name = cfg.get("architecture", "unet")
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise SystemExit(f"bench: architecture {name!r} is not a plain "
                         "name (letters, digits, _)")
    path = os.path.join(root, "benchmark", "architectures", name + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"bench: the configuration names architecture "
                         f"{name!r}, and {path} does not exist")
    return _load_file(path, "bench_architecture_" + name)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _seeds(seed):
    """Independent streams from one ``--seed`` of any size: the survey's
    (a 32-bit numpy seed), the weights' (a torch seed) and the check's
    draws."""
    import numpy as np
    ss = np.random.SeedSequence(int(seed))
    data, weights, draws = ss.spawn(3)
    return (int(data.generate_state(1)[0]),
            int(weights.generate_state(1, np.uint64)[0] >> np.uint64(1)),
            np.random.default_rng(draws))


def _inputs(cell, seed, spec, make):
    """The cell's inputs for ``seed``, made once and kept under
    ``build/benchmark/inputs/<cell>/<seed>`` (at most KEEP_INPUT_SETS
    seeds a cell); returns (path, seconds spent making them)."""
    base = os.path.join(WORK, "inputs", cell)
    folder = os.path.join(base, str(seed))
    done = os.path.join(folder, "done.json")
    if os.path.isfile(done):
        with open(done) as f:
            return json.load(f)["path"], 0.0
    t0 = time.perf_counter()
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    path = make(spec, folder)
    # write the new files back now, or their writeback competes with the
    # first run's window for the disk
    os.sync()
    with open(done, "w") as f:
        json.dump({"path": path}, f)
    sets = sorted((os.path.getmtime(os.path.join(base, d)), d)
                  for d in os.listdir(base) if d != str(seed))
    for _, d in sets[:max(len(sets) - KEEP_INPUT_SETS + 1, 0)]:
        shutil.rmtree(os.path.join(base, d), ignore_errors=True)
    return path, time.perf_counter() - t0


class Spans:
    """The benchmark's host spans of a traced run: (name, start, end) in
    wall-clock nanoseconds, the clock the profiler's trace is based on."""

    def __init__(self):
        self.rows = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.time_ns()))


def _untraced(name):
    return contextlib.nullcontext()


def _checks(numbers, limits):
    """{name: {"value", "limit"}} and whether every number is within its
    limit."""
    out, ok = {}, True
    for k, v in numbers.items():
        if k not in limits:
            continue
        out[k] = {"value": v, "limit": limits[k]}
        ok = ok and v <= limits[k]
    return out, ok


def run_cell(bench, name, seed, seconds, trace, device="cuda",
             overrides=None, fault=None, root=ROOT, control=False):
    """One run of cell ``name``; returns the result dict (the last line
    of a run).  ``overrides`` (tests) updates the workload and config;
    ``fault`` (tests) is called with the cell before its warm-up to break
    the timed path underneath; ``control`` (the control script) adds the
    numbers of the control, the reference at the precision below the
    configuration's in the program's place, as ``control_checks``."""
    import torch

    from benchmark.yardstick import counts
    from benchmark.yardstick.trace import Trace, profiled, remove

    _, _, work, cfg = cell_files(bench, name, root)
    overrides = overrides or {}
    work = dict(work, **overrides.get("workload", {}))
    cfg = dict(cfg, **overrides.get("config", {}))
    cfg["device"] = device
    arch = load_architecture(cfg, root)
    kind = work["kind"]
    data_seed, weight_seed, rng = _seeds(seed)
    run_dir = os.path.join(WORK, "run", name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    span = Spans() if trace else _untraced

    train = kind == "train"
    cells = importlib.import_module(
        "benchmark.yardstick." + ("train_cell" if train else "predict_cell"))
    input_path, gen_s = _inputs(
        name, seed, work["survey"],
        lambda spec, folder: cells.make_inputs(spec, folder, data_seed))
    print(f"bench: inputs {input_path} made in {gen_s:.3f} s "
          "(not counted in setup_s)", file=sys.stderr)

    gen = torch.Generator(device=device).manual_seed(weight_seed)
    cell = cells.build(cfg, work, input_path, gen, device, rng, arch)
    if fault is not None:
        fault(cell)
    cell.warm_up(run_dir)

    metrics, ctx = {}, {}
    if not trace:
        t_window = time.perf_counter()
        setup_s = t_window - T_START - gen_s
        done, wall = cell.window(seconds, span)
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        print(f"bench: the window ran {done} {'crops' if train else 'pings'}"
              f" in {wall!r} s", file=sys.stderr)
        if train:
            metrics["crops_per_s"] = {"value": done / wall,
                                      "unit": "crops/s"}
    else:
        tpath = os.path.join(run_dir, "trace.json")
        before = cell.timer_snapshot()
        with profiled(tpath, device):
            with span("bench.window"):
                done, wall = cell.traced(span)
        tr = Trace(tpath, span.rows)
        print(f"bench: {tr.inside_share()} of the traced device activity "
              "lies inside the window", file=sys.stderr)
        remove(tpath)
        ctx = {"trace": tr, "window_s": tr.window_s(),
               "busy_s": tr.busy_s(), "timer": cell.timer_delta(before),
               "done": done, "wall_s": wall}
        ctx.update(cell.layer_context(done))
    cell.after_window()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    if not trace and device != "cpu":
        metrics["peak_device_mem_gib"] = {"value": peak / 2 ** 30,
                                          "unit": "GiB"}
    chunks_done = cell.attempted()
    cell.free()

    numbers = cell.judge()
    checks, ok = _checks(numbers, work["limits"])
    ctl_numbers = cell.judge("fp8") if control else None
    ctl = _checks(ctl_numbers, work["limits"]) if control else None
    failed = cell.failed()

    reported = {}
    for m in metrics_of(bench, name, trace):
        if not trace:
            if m["name"] in metrics:
                reported[m["name"]] = metrics[m["name"]]
            continue
        value = load_reader(m["name"], root)(ctx)
        if value is not None:
            reported[m["name"]] = {"value": value, "unit": m["unit"]}

    kind_name = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": kind_name, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0),
              "attempted": int(chunks_done), "failed": int(failed),
              "metrics": reported, "device": dev}
    if trace:
        dev["busy_s"] = ctx["busy_s"]
        dev["window_s"] = ctx["window_s"]
        result["breakdown"] = {"device_ops": ctx["trace"].top_ops(10),
                               "idle_gaps": ctx["trace"].idle_gaps(10)}
    if ctl is not None:
        result["control_checks"] = ctl[0]
        result["control_correct"] = ctl[1]
        result["readings"] = {"program": numbers, "control": ctl_numbers}
    result["checks"] = checks
    if device != "cpu":
        print(f"bench: peaks {counts.PEAK_BF16_FLOPS:.4g} FLOP/s bf16, "
              f"{counts.PEAK_HBM_BYTES:.4g} B/s HBM; power limit "
              f"{counts.power_limit_watts()} W", file=sys.stderr)
    shutil.rmtree(run_dir, ignore_errors=True)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_env()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench = load_bench()
    entry, _, _, _ = cell_files(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"bench: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      args.trace)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
