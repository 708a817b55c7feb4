"""Run one cell of the benchmark of ``latteclip_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``; the kind of cell (the mix's ``kind``) by its module
``benchmark/<kind>_cell.py``; the per-layer metrics by their readers under
``benchmark/metrics/``. An end-to-end metric ``<quantity>.<group>`` reports
the cell's ``<quantity>`` under a bound of the group's own. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, ``built_kernels``: whether set-up compiled a kernel,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number of the
correctness check with its limit). Exits non-zero without a result where
there is no CUDA card, fewer cards than the cell asks for, no port, or no
module for the mix's kind.
"""
import time

T0 = time.perf_counter()  # set-up counts from here

import atexit  # noqa: E402
import subprocess  # noqa: E402

SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def _smi():
    """nvidia-smi started in the background (None where there is none); it
    is waited for before the process ends."""
    try:
        proc = subprocess.Popen(SMI, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None
    atexit.register(proc.wait)
    return proc


# the card's name and power limit, read beside the imports
CARD = _smi() if __name__ == "__main__" else None

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench_cache", _sub)
os.environ["USE_FLAX"] = "0"  # keep libraries from loading JAX by themselves
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "latteclip_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts: str):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def find_cell(m: dict, workload: str, root: str = ROOT):
    """(workload entry, configuration file's contents, traffic mix) by name."""
    wl = {w["name"]: w for w in m["workloads"]}[workload]
    config = {c["name"]: c for c in m["configs"]}[wl["config"]]
    mix = load_json(root, "benchmark", "traffic", wl["traffic"] + ".json")
    return wl, load_json(root, config["file"]), mix


def cell_metrics(m: dict, section: str, workload: str) -> list:
    return [e for e in m[section] if workload in e.get("workloads", [workload])]


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    """The ``read(records)`` function of ``benchmark/metrics/<name>.py``."""
    return _load(os.path.join(root, "benchmark", "metrics", name + ".py"),
                 f"benchmark_metric_{name}").read


def cell_kind(kind: str, root: str = ROOT):
    """The module ``benchmark/<kind>_cell.py`` that runs a mix of this kind,
    or None where there is none."""
    path = os.path.join(root, "benchmark", f"{kind}_cell.py")
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind) or not os.path.exists(path):
        return None
    return _load(path, f"benchmark_cell_{kind}")


def quantity(name: str) -> str:
    """What a cell measures for the end-to-end metric ``name``: the part
    before the first dot (``train_images_per_s.b16`` is the cell's
    ``train_images_per_s`` under the ViT-B/16 bound)."""
    return name.split(".")[0]


def built_kernels() -> dict:
    """Whether this process compiled a kernel of the port, and the longest
    build's seconds (``kernels/build.py``'s log, empty until it loads)."""
    from latteclip_torch.kernels import build

    seconds = [float(v.get("seconds", 0.0)) for v in getattr(build, "build_log", {}).values()]
    return {"built": any(s > 0 for s in seconds), "build_s": max(seconds, default=0.0)}


def forbidden_modules() -> list:
    """Modules loaded whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    proc = CARD or _smi()
    out = proc.communicate(timeout=60)[0] if proc else ""
    return out.strip().splitlines()[0] if proc and proc.returncode == 0 and out.strip() else \
        "nvidia-smi unavailable"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Ctx:
    """What a kind of cell needs: the arguments, the configuration's widths,
    the mix, the device, its sync, the limits and the clock's origin."""

    def __init__(self, args, wl, raw_config, mix, device, t0, root=ROOT, phases=None):
        import torch

        from benchmark.reference import Dims

        self.args, self.wl, self.raw_config, self.mix = args, wl, raw_config, mix
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.dims = Dims(raw_config)
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.sync = (lambda: torch.cuda.synchronize(self.dev)) if self.cuda else (lambda: None)
        path = os.path.join(root, "benchmark", "limits", wl["name"] + ".json")
        self.limits = load_json(path) if os.path.exists(path) else {}
        self.t0 = t0
        self.phases = dict(phases or {})  # set-up phase -> seconds, to standard error
        self._mark = t0 + sum(self.phases.values())

    def mark(self, phase: str) -> None:
        """The set-up phase that ends now."""
        now = time.perf_counter()
        self.phases[phase] = now - self._mark
        self._mark = now

    def port_config(self):
        """The port's configuration of the model that the file names, held
        to the file's widths."""
        from latteclip_torch.config import get_model_config

        cfg = get_model_config(self.raw_config["model"])
        v, t, d = cfg.vision, cfg.text, self.dims
        got = (cfg.embed_dim, v.image_size, v.patch_size, v.width, v.layers, v.heads, t.context_length,
               t.vocab_size, t.width, t.heads, t.layers)
        want = (d.embed, d.image, d.patch, d.v_width, d.v_layers, d.v_heads, d.ctx, d.vocab, d.t_width,
                d.t_heads, d.t_layers)
        if got != want:
            raise SystemExit(f"{cfg.name}: the port's widths {got} are not the file's {want}")
        return cfg

    def load_model(self, weights):
        """The port's model of the seed's OpenCLIP state dict: the module
        built on the device and loaded with ``strict=True``, as the port's
        checkpoint loader ends."""
        import torch

        from latteclip_torch.models import clip as clip_mod

        with torch.device(self.dev):
            model = clip_mod.build_model(self.port_config())
        model.load_state_dict(weights, strict=True)
        return model


def main(argv=None, device=None, root: str = ROOT) -> int:
    """One run. ``device`` (tests only) skips the look for a card and runs
    there; ``root`` (tests only) holds another manifest and its files."""
    args = parse(argv)
    m = manifest(root)
    wl, raw_config, mix = find_cell(m, args.workload, root)
    import torch

    phases = {"python_torch": time.perf_counter() - T0}
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            log(f"needs {wl['chips']} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
            return 2
        device = "cuda"
        log(f"card: {card_line()}")
    if importlib.util.find_spec("latteclip_torch") is None:
        log("latteclip_torch is not in this checkout: no result")
        return 3
    kind = cell_kind(mix["kind"], root)
    if kind is None:
        log(f"no benchmark/{mix['kind']}_cell.py for the mix {wl['traffic']}'s kind: no result")
        return 5
    phases["card"] = time.perf_counter() - T0 - phases["python_torch"]
    ctx = Ctx(args, wl, raw_config, mix, device, T0, root, phases)
    out = kind.run(ctx)
    built = built_kernels()
    log("set-up phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in ctx.phases.items())
        + f"; kernels built {built['built']}, longest build {built['build_s']:.1f} s")

    if args.trace:
        metrics = {}
        for e in cell_metrics(m, "per_layer", wl["name"]):
            value = reader(e["name"], root)(out["records"])
            if value is not None:
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    else:
        metrics = {e["name"]: {"value": out["end_to_end"][quantity(e["name"])], "unit": e["unit"]}
                   for e in cell_metrics(m, "end_to_end", wl["name"])}
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}: no result")
        return 4
    checks = out["checks"]
    correct = out["failed"] == 0 and all(
        c["limit"] is not None and c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev, "built_kernels": built["built"]}
    if args.trace:
        prof = out["records"]["trace"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
