"""The benchmark's core: one cell's run, found by name in BENCHMARK.json.

A cell names a configuration (``configs/<config>.json``: the scene builder,
its size and settings per loop), a traffic mix (``traffic/<traffic>.json``:
the loop, the camera's walk and jitter, the warm-up, how many items the check
and the trace take) and, through BENCHMARK.json, its metrics: an end-to-end
metric is a reader ``e2e/<name>.py`` of the measured window, a per-layer
metric a reader ``metrics/<name>.py`` (with its data in
``metrics/<name>.json``) of the traced items.  ``checks/<workload>.json`` holds the cell's limits of ``correct``.
Adding a cell or a metric adds files and entries; nothing here names one.

A run: set-up (the scene packed for the program, the warm-up items), the
measured window of ``seconds`` (one client, closed loop: the next item is
issued when the last one is on the host), then with ``trace`` a fixed number
of items under torch.profiler, then the peak memory, then the program's state
is dropped and the reference judges the sample of the window's items that
the seed draws.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time

import torch

from . import check, generator, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "chess2rt_tpu")


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def load_reader(folder: str, name: str):
    """The reader module ``<folder>/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_data(name: str) -> dict:
    path = os.path.join(HERE, "metrics", f"{name}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def metrics_of(entries: list, workload: str) -> list:
    """The metrics of ``entries`` that this cell reports."""
    return [m for m in entries if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load
    (compared whole: ``chess2rt_tpu_torch`` is not ``chess2rt_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return res.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name(dev)} (nvidia-smi not read: {e})"


def _quartiles_ms(lat) -> str:
    """min, q1, median, q3, max of the window's item times, in ms: whether a
    slow run is slow throughout or held up by a few stalls."""
    if len(lat) < 2:
        return "too few items"
    q = statistics.quantiles(lat, n=4)
    return ", ".join(f"{1e3 * x:.3f}" for x in (min(lat), *q, max(lat)))


def _own(out):
    """A kept item's own copy: a frame lives in the client's reused buffer."""
    return out.clone() if torch.is_tensor(out) else out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device, t_start: float,
             size=None, port_factory=None, log=None, numbers=None) -> dict:
    """One run of ``workload``: the result line's dict.  ``size`` (w, h)
    replaces the configuration's frame size (the tests' small runs);
    ``port_factory(config, mode, seed, device)`` replaces the program's
    adapter (the tests' faults); ``numbers``, a dict, receives every number
    the check read, those without a limit too (the readings)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = load_benchmark()
    cell = find(bench["workloads"], workload, "workload")
    config = load_config(cell["config"])
    traffic = generator.load_traffic(cell["traffic"])
    loop = traffic["loop"]
    mode = dict(config[loop])
    if size is not None:
        mode.update(width=int(size[0]), height=int(size[1]))
    inputs = generator.Inputs(seed, traffic, check.camera_basis(config, mode))
    limits = check.load_limits(workload)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if port_factory is None:
        from .port import Port as port_factory

    # ---- set-up: the scene, the warm-up items
    t_scene = time.perf_counter()
    port = port_factory(config, mode, seed, dev)
    t_warm = time.perf_counter()

    def item(key, jit):
        if loop == "frames":
            return port.frame(jit, key)
        return (*port.step(jit, key), port.leaf_names)

    for j in range(int(traffic["warmup"])):
        item(*inputs.warm(j))
    _sync(dev)

    # ---- the measured window
    kept = generator.Reservoir(seed, int(traffic["check_items"]))
    lat, failed, n = [], 0, 0
    t_first = time.perf_counter()
    t_last = t_first
    while t_last - t_first < seconds:
        key, jit = inputs.item(n)
        before = port.counts()
        t0 = time.perf_counter()
        out = item(key, jit)
        t_last = time.perf_counter()
        after = port.counts()
        lat.append(t_last - t0)
        # on a card an item that launched no K1, or that the eager twin
        # rendered, did not measure the program's path (the CPU has no kernel)
        if on_card and (after["k1"] <= before["k1"] or after["twin"] != before["twin"]):
            failed += 1
        kept.offer(n, out, _own)
        n += 1
    out = None
    window = {"loop": loop, "setup_s": t_first - t_start, "window_s": t_last - t_first, "n": n,
              "latencies_s": lat}
    metrics = {}
    if not traced:
        for m in metrics_of(bench["end_to_end"], workload):
            v = load_reader("e2e", m["name"]).read(window)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # ---- the traced items, after the window
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": 1}
    breakdown = None
    if traced:
        _sync(dev)
        tr = trace.profile_items(lambda i: item(*inputs.item(i)), n, int(traffic["trace_items"]), dev)
        ref_packed, ref_static = check.reference_scene(config, mode, seed, "cpu")
        ctx = {"loop": loop, "mode": mode, "config": config, "ref_static": ref_static, "ref_packed": ref_packed,
               "harness_syncs_per_item": 1}
        for m in metrics_of(bench["per_layer"], workload):
            v = load_reader("metrics", m["name"]).read(tr, dict(ctx, data=load_data(m["name"])))
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_us / 1e6, window_s=tr.window_us / 1e6)
        breakdown = {"device_ops": trace.top_device_ops(tr), "idle_gaps": trace.top_idle_gaps(tr)}
        log(f"rtbench: traced {tr.n_items} items: {len(tr.kernels)} kernels, {tr.busy_us / 1e3:.3f} ms busy "
            f"of {tr.window_us / 1e3:.3f} ms")
    device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0

    # ---- the program's state dropped, then the reference judges the sample
    port.free()
    port = None
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    found = check.judge(kept.sample(), loop, config, mode, inputs, dev, limits,
                        detail=None if numbers is None else numbers.setdefault("leaves", []))
    ref_s = time.perf_counter() - t0
    if numbers is not None:
        numbers.update(found)
    correct = failed == 0 and check.passes(found, limits)
    log(f"rtbench: {workload} seed {seed}: {n} items in {window['window_s']:.3f} s, set-up "
        f"{window['setup_s']:.3f} s (to the scene {t_scene - t_start:.3f}, scene {t_warm - t_scene:.3f}, warm-up "
        f"{t_first - t_warm:.3f}), {failed} failed, reference {ref_s:.3f} s; {card_line(dev)}; item ms "
        f"(min, quartiles, max): {_quartiles_ms(lat)}")
    for k, lim in limits.items():
        log(f"check {k}: {found.get(k, float('nan'))!r} {'must exceed' if lim.get('above') else 'limit'} "
            f"{lim['limit']!r}")
    result = {"correct": bool(correct), "attempted": n, "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": found.get(k), "limit": lim["limit"], "above": bool(lim.get("above"))}
                       for k, lim in limits.items()}
    return result
