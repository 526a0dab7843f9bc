"""Run one cell of the benchmark of ``kspider_tpu_torch`` on this machine's card.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``gpubench/configs/<name>.json``) and traffic mix
(``gpubench/mixes/<name>.json``); the per-layer metrics are read by
``gpubench/metrics/<name>.py``.  One run:

1. Set-up (``setup_s``): imports, the CUDA context, the program's kernels
   (built into the checkout on a first run), a collection drawn from
   ``--seed`` and written as the index the program loads, one warm-up job.
2. The window: jobs back to back, each the mix's commands run in-process
   through the program's CLI with ``--device cuda``, the outputs of the
   job before removed first.  It closes at the end of the first job that
   ends after ``--seconds``.  A stage's wall is the host clock from the
   command's call to its return.  With ``--trace 1`` the whole run after
   the imports is under ``torch.profiler`` and the per-layer metrics are
   read from the window's part of the trace.
3. The last job's files are compared with the plain reference
   (``check.py``); each number compared is printed beside its limit as the
   last lines of standard error and under ``checks``, the result line's
   last key.

The last line of standard output is the result, one JSON object.  Exits
non-zero with no result without a CUDA card (or fewer than the cell asks
for), when the program cannot be imported, or when JAX or the JAX package
was loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "kspider_tpu")
#: build and kernel caches, at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, ".gpubench_cache")
GIB = float(1 << 30)
#: the profiler range around the measured window
WINDOW_RANGE = "window"


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, name: str, root: str = ROOT):
    """(workload entry, configuration dict, mix dict) of the named cell."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    work = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "gpubench", "mixes",
                           work["traffic"] + ".json")) as f:
        mix = json.load(f)
    return work, config, mix


def load_metric(name: str, declared: dict, root: str = ROOT):
    """The reader module ``gpubench/metrics/<name>.py``; its declarations
    must agree with the metric's entry in ``BENCHMARK.json``."""
    path = os.path.join(root, "gpubench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("layer", "unit", "better", "source", "moves"):
        if getattr(mod, key.upper()) != declared[key]:
            raise ValueError(f"metrics/{name}.py: {key.upper()} = "
                             f"{getattr(mod, key.upper())!r}, BENCHMARK.json "
                             f"says {declared[key]!r}")
    return mod


def argv_of(stage: dict, prefix: str, device: str):
    """The command line of one stage: ``true`` options are flags."""
    argv = [stage["command"], "-i", prefix, "--device", device]
    for key, value in stage.get("options", {}).items():
        argv += [key] if value is True else [key, str(value)]
    return argv


def seed_rng_key(seed: int):
    """The generator's seed: any whole number, negative ones apart."""
    return [abs(int(seed)), int(seed < 0)]


def peak_rss_bytes() -> int:
    """The process's peak resident memory since it started, in bytes
    (``ru_maxrss``, which Linux gives in KiB)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if peak <= 0:
        raise RuntimeError("getrusage gives no peak resident memory here")
    return peak


def _written_bytes() -> int:
    """Bytes this process passed to ``write`` calls (``wchar``), or -1."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def _card(torch) -> dict:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        line = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        line = "not read"
    return {"nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda}


class Jobs:
    """Runs the mix's commands through the program's CLI, in-process."""

    def __init__(self, mix: dict, prefix: str, device: str):
        import torch
        from torch.profiler import record_function
        from kspider_tpu_torch.cli.main import cli

        self.torch, self.record, self.cli = torch, record_function, cli
        self.stages = mix["stages"]
        self.prefix, self.device = prefix, device
        self.cuda = device.startswith("cuda")

    def clear(self):
        for path in glob.glob(self.prefix + "_kSpider_*"):
            os.remove(path)

    def run(self) -> dict:
        """One job: each stage's wall in seconds."""
        self.clear()
        walls = {}
        for stage in self.stages:
            name = stage["command"]
            argv = argv_of(stage, self.prefix, self.device)
            with self.record("gpubench." + name):
                t0 = time.perf_counter()
                with open(os.devnull, "w") as sink, \
                        contextlib.redirect_stdout(sink):
                    self.cli.main(args=argv, prog_name="kspider",
                                  standalone_mode=False)
                if self.cuda:
                    self.torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
        return walls


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", root: str = ROOT) -> dict:
    """One run of the cell; returns the result (see the module's doc).
    ``device`` other than cuda (the tests' ``cpu``) runs the same path
    without the card's counters."""
    _, config, mix = cell(bench, workload, root)
    for key in [k for k in os.environ if k.startswith("KSPIDER_")]:
        del os.environ[key]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)

    import torch
    from gpubench import check, datagen, roofline
    from gpubench import trace as tr

    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    layers = [m for m in bench["per_layer"] if applies(m, workload)]
    readers_of = {m["name"]: load_metric(m["name"], m, root) for m in layers}
    cuda = device.startswith("cuda")
    if cuda:
        from kspider_tpu_torch.ops import _build

        _build.library()  # built into the checkout on a first run
        torch.cuda.init()

    work_dir = tempfile.mkdtemp(prefix="gpubench.")
    prof = None
    try:
        col = datagen.generate(config, seed_rng_key(seed))
        prefix = os.path.join(work_dir, "derep")
        datagen.write_index(col, prefix)
        jobs = Jobs(mix, prefix, device)
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        walls = {s["command"]: [] for s in mix["stages"]}
        failed = attempted = 0
        try:
            jobs.run()  # warm-up: kernels, native library, pinned memory
        except (Exception, SystemExit):
            failed = attempted = 1
            traceback.print_exc()
        jobs.clear()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t_open = time.perf_counter()
        setup_s = t_open - T0
        with jobs.record(WINDOW_RANGE):
            while not failed:
                attempted += 1
                try:
                    for name, s in jobs.run().items():
                        walls[name].append(s)
                except (Exception, SystemExit):
                    failed += 1
                    traceback.print_exc()
                    break
                if time.perf_counter() - t_open >= seconds:
                    break
        window_s = time.perf_counter() - t_open
        peak_host = peak_rss_bytes()
        peak_device = torch.cuda.max_memory_allocated() if cuda else 0
        done = attempted - failed

        metrics, device_info, breakdown = {}, {}, None
        if traced:
            prof.stop()
            trace_path = os.path.join(work_dir, "trace.json")
            prof.export_chrome_trace(trace_path)
            prof = None
            context = {"kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                       "work": {s["command"]: roofline.stage_work(
                           s["command"], s.get("options", {}), col.offsets,
                           col.members, col.counts, col.n)
                           for s in mix["stages"]}}
            events = tr.load_events(trace_path)
            os.remove(trace_path)
            mark = [e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == WINDOW_RANGE]
            lo, hi = (mark[0]["ts"], mark[0]["ts"] + mark[0]["dur"]) if mark \
                else (0.0, 0.0)
            win = tr.Window(events, lo, hi, context)
            for m in layers:
                value = readers_of[m["name"]].read(win)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info = {"busy_s": win.busy_ms() / 1000.0,
                           "window_s": (hi - lo) / 1e6}
            breakdown = {"device_ops": tr.device_ops(win),
                         "idle_gaps": tr.idle_gaps(win)}
        else:
            for m in e2e:
                name = m["name"]
                if name == "setup_s":
                    value = setup_s
                elif name == "peak_host_gib":
                    value = peak_host / GIB
                elif name.endswith("_s") and name[:-2] in walls:
                    value = sum(walls[name[:-2]]) / done if done else None
                else:
                    raise ValueError(f"no way to measure {name!r}")
                if value is not None:
                    metrics[name] = {"value": value, "unit": m["unit"]}

        # the program's state goes before the reference runs
        del jobs
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        exp = check.Expected(col)
        readings = check.judge(prefix, exp, mix["stages"])
        correct = failed == 0 and done > 0 and all(r.ok for r in readings)
        result = {
            "correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics,
            "device": dict({"platform": "gpu" if cuda else device,
                            "kind": torch.cuda.get_device_name(0) if cuda else device,
                            "count": 1,
                            "memory_peak_bytes": int(peak_device)},
                           **device_info),
        }
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["run"] = {"seed": seed, "jobs": done, "window_s": window_s,
                         "setup_s": setup_s, "walls": walls,
                         "peak_host_bytes": peak_host,
                         "collection": {"genomes": col.n,
                                        "colors": int(len(col.counts)),
                                        "postings": int(len(col.members))},
                         "written_bytes": _written_bytes()}
        if cuda:
            result["card"] = _card(torch)
        result["checks"] = {r.name: {"value": r.value, "limit": r.limit}
                            for r in readings}
        return result
    finally:
        if prof is not None:
            prof.stop()
        shutil.rmtree(work_dir, ignore_errors=True)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    work = cell(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in this process: {loaded}",
              file=sys.stderr)
        return 3
    print(f"bytes written by this process: {result['run']['written_bytes']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
