"""The dry-run's roofline and census tables from its JSON cells, and the
tuned-policy summary (the apps' tuning cache and the serve artifacts
under ``results/tuned/``): the port of ``repro.launch.report``.

``python -m repro_torch.launch.report [results/dryrun_torch]``

The times are the port's roofline terms at one H100's data-sheet rates
(``launch/hlo_analysis.py``), computed from counts on ``meta`` tensors
(``launch/dryrun.py``): bounds, not measurements.  The last column of
the census is the seconds the cell's step took to run on ``meta`` (the
reference prints its compile time there).
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.core.formats import get_format

TUNING_CACHE = "results/paper/tuning_cache.json"
TUNED_DIR = "results/tuned"


def load(dirname, mesh, policy="transprecision", tag=None):
    cells = {}
    for fn in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(fn) as f:
            d = json.load(f)
        if d.get("mesh") != mesh or d.get("policy") != policy:
            continue
        if (d.get("tag") or None) != tag:
            continue
        cells[(d["arch"], d["shape"])] = d
    return cells


def fmt_bytes(b):
    if b >= 1e12:
        return f"{b/1e12:.1f}T"
    if b >= 1e9:
        return f"{b/1e9:.1f}G"
    if b >= 1e6:
        return f"{b/1e6:.1f}M"
    return f"{b/1e3:.0f}K"


def roofline_table(cells) -> str:
    hdr = ("| arch | shape | kind | t_compute | t_memory | t_collective | "
           "dominant | MODEL/COUNTED flops | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for (arch, shape), d in sorted(cells.items()):
        if d["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | — | — | — | — | "
                        f"*skipped: sub-quadratic attention required* "
                        f"| — | — |")
            continue
        if d["status"] != "ok":
            rows.append(f"| {arch} | {shape} | ERROR | | | | | | |")
            continue
        r = d["roofline"]
        rows.append(
            f"| {arch} | {shape} | {d['kind']} | {r['t_compute_s']:.4g} s | "
            f"{r['t_memory_s']:.4g} s | {r['t_collective_s']:.4g} s | "
            f"**{r['dominant']}** | {r['useful_flops_ratio']:.3f} | "
            f"{100*r['roofline_fraction']:.1f}% |")
    return hdr + "\n".join(rows)


def dryrun_table(cells) -> str:
    hdr = ("| arch | shape | flops/dev | bytes/dev | coll bytes/dev | "
           "AG / AR / RS / A2A / CP | run on meta |\n"
           "|---|---|---|---|---|---|---|\n")
    rows = []
    for (arch, shape), d in sorted(cells.items()):
        if d["status"] != "ok":
            continue
        c = d["collectives"]
        kinds = "/".join(str(int(c[k]["count"])) for k in
                         ("all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute"))
        rows.append(
            f"| {arch} | {shape} | {d['flops_per_device']:.3g} | "
            f"{fmt_bytes(d['bytes_per_device'])} | "
            f"{fmt_bytes(d['collective_bytes_per_device'])} | {kinds} | "
            f"{d['run_s']:.1f}s |")
    return hdr + "\n".join(rows)


def _fmt_hist(policy) -> str:
    hist = {}
    for f in policy.formats.values():
        name = get_format(f).name
        hist[name] = hist.get(name, 0) + 1
    return " ".join(f"{k}:{v}" for k, v in sorted(hist.items()))


def tuning_table() -> str:
    """Tuned bindings (apps cache + serve artifacts), read through the
    loader ``launch/serve.py --policy`` uses: every row round-trips
    ``PrecisionPolicy.from_artifact``, so a binding that prints here is a
    binding that serves."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.tuning.artifact import load_policy

    hdr = ("| binding | mode | formats | error | vs f32 |\n"
           "|---|---|---|---|---|\n")
    rows = []
    if os.path.exists(TUNING_CACHE):
        with open(TUNING_CACHE) as f:
            cache = json.load(f)
        for app, entry in sorted(cache.get("apps", {}).items()):
            for key, v in sorted(entry.items()):
                if not (isinstance(v, dict) and "artifact" in v):
                    continue
                policy = PrecisionPolicy.from_artifact(v["artifact"])
                prov = v["artifact"]["provenance"]
                rows.append(
                    f"| {app} {key} | {policy.mode} | "
                    f"{_fmt_hist(policy)} | "
                    f"{prov['final_error']:.2e} | "
                    f"{prov['bytes'] / max(prov['bytes_f32'], 1):.2f}x |")
    for fn in sorted(glob.glob(os.path.join(TUNED_DIR, "*.json"))):
        policy = load_policy(fn)
        with open(fn) as f:
            prov = json.load(f).get("provenance", {})
        rows.append(
            f"| {os.path.basename(fn)} | {policy.mode} | "
            f"{_fmt_hist(policy)} | "
            f"{prov.get('final_kl', float('nan')):.2e} | "
            f"{prov.get('bytes_vs_f32', float('nan')):.2f}x |")
    return hdr + "\n".join(rows) if rows else ""


def render(dirname: str) -> str:
    out = []
    for mesh in ("single", "multi"):
        cells = load(dirname, mesh)
        if not cells:
            continue
        n_ok = sum(1 for d in cells.values() if d["status"] == "ok")
        out += [f"\n### {mesh} mesh ({n_ok} ok / {len(cells)} cells)\n",
                roofline_table(cells), "", dryrun_table(cells)]
    tuned = tuning_table()
    if tuned:
        out += ["\n### tuned precision bindings\n", tuned]
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print(render(argv[0] if argv else "results/dryrun_torch"))


if __name__ == "__main__":
    main()
