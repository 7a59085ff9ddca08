"""Runs the SCV SpMM kernels of two checkouts of this repository on one
card, on the same seeded inputs, and compares their outputs bit for bit.

    python3 scripts/compare_trees.py BASE [HEAD]

BASE and HEAD are checkouts (HEAD defaults to the one holding this
script); each builds its own kernel library from its own sources.  Each
checkout runs in a process of its own, in turns BASE, HEAD, HEAD, BASE, on
real-valued inputs made from fixed seeds: the arxiv-scale chain at F = 128
and F = 40, the serving composite's chain (the warm-up burst's first wave,
as ``chip_smoke.py`` builds it), the arxiv-scale backward's dZ chain over
the transposed plan, the first segment's launch alone on both graphs, and
the 8,192-node dense-block graph's chain with the dense branch on and off.
Inputs and timing are ``chip_smoke.py``'s (this checkout's): the serving
composite from ``warm_up_composite``, the arxiv-scale graph from
``arxiv_adjacency``, device times from ``device_ms``.  For each case it
prints the device time of every turn and whether the outputs of the two
checkouts, and of the two turns of one checkout, are equal bit for bit
(compared as int32 words, so a -0.0 against a 0.0 counts).  Exits 1 when
any output differs.  Needs one card; the outputs are kept in a temporary
directory of the checkout while it runs, and the times and verdicts go to
``chiprun_out/compare_trees/summary.json``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "chiprun_out", "compare_trees")
REPS = 20


def worker(tree: str, out_path: str, only: str | None = None) -> None:
    """Runs every case (or those whose name holds ``only``) with the
    kernels of ``tree``; saves the outputs and times to ``out_path``."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, HERE)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import gcn_paper
    from repro_torch.core.scv import transposed_plan
    from repro_torch.kernels.scv_spmm.build import load_library
    from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan
    from repro_torch.launch.graph_serve import default_pool
    from repro_torch.models.gnn import build_graph
    from repro_torch.simul.datasets import gcn_normalize, powerlaw_edges
    from repro_torch.tune.config import TunedConfig

    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    assert os.path.realpath(kmod.__file__).startswith(os.path.realpath(tree)), kmod.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = load_library()
    cfg = gcn_paper.full
    comp = smoke.warm_up_composite(dict(model=cfg, device=dev, seed=0), default_pool(),
                                   cfg.d_in)[2].plan
    arxiv = build_graph(smoke.arxiv_adjacency(), config=TunedConfig(), with_edges=False,
                        device=dev).plan
    segs = arxiv.segments
    arxiv_t = transposed_plan(arxiv).reweighted(torch.cat([s.vals.reshape(-1) for s in segs]))
    rng = np.random.default_rng(7)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)

    def first_segment(plan, z):
        s = plan.segments[0]
        out = torch.zeros((plan.padded_shape[0], z.shape[1]), device=dev)
        return lambda: kmod.scv_spmm_runs(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows,
                                          s.cols, s.vals, z, out, s.runs, tile=s.tile,
                                          accumulate=False)

    z128, z40 = normal(arxiv.shape[1], 128), normal(arxiv.shape[1], 40)
    zc = normal(comp.shape[1], 128)
    cot = normal(arxiv_t.shape[1], 128)
    dense = []  # the 8,192-node graph's plan and its Z, built at first use

    def dense_chain(threshold=None):
        if not dense:
            plan = build_graph(gcn_normalize(powerlaw_edges(8192, 4_000_000, seed=0)),
                               bucket_caps="auto", with_edges=False, device=dev).plan
            dense.extend([plan, normal(plan.shape[1], 128)])
        return scv_spmm_plan(*dense, dense_threshold=threshold)
    cases = {
        "arxiv chain F=128": lambda: scv_spmm_plan(arxiv, z128),
        "arxiv chain F=40": lambda: scv_spmm_plan(arxiv, z40),
        "serving chain F=128": lambda: scv_spmm_plan(comp, zc),
        "arxiv dZ chain F=128": lambda: scv_spmm_plan(arxiv_t, cot),
        "arxiv first segment F=128": first_segment(arxiv, z128),
        "serving first segment F=128": first_segment(comp, zc),
        "8192/4M chain F=128": dense_chain,
        "8192/4M chain F=128, dense branch off": lambda: dense_chain(-1),
    }
    result = {"tree": tree, "library": lib.path.name, "device": torch.cuda.get_device_name(0),
              "ms": {}, "outputs": {}}
    for name, fn in cases.items():
        if only is not None and only not in name:
            continue
        out = fn()
        torch.cuda.synchronize()
        result["outputs"][name] = out.detach().cpu().clone()
        result["ms"][name] = smoke.device_ms(fn, REPS)
    torch.save(result, out_path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?")
    ap.add_argument("head", nargs="?", default=HERE)
    ap.add_argument("--only", help="run only the cases whose name holds this text")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, only=args.only)
        return 0
    if args.base is None:
        ap.error("BASE is required")
    import torch

    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    turns = [("base", args.base), ("head", args.head), ("head", args.head), ("base", args.base)]
    runs = []
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for i, (label, tree) in enumerate(turns):
            path = os.path.join(tmp, f"turn{i}_{label}.pt")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                            os.path.abspath(tree), path]
                           + (["--only", args.only] if args.only else []),
                           check=True, cwd=os.path.abspath(tree))
            runs.append((label, torch.load(path)))
            print(f"[turn {i}] {label} ({os.path.abspath(tree)}, {runs[-1][1]['library']}) in "
                  f"{time.perf_counter() - t0:.1f} s")

    def same(a, b) -> bool:
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    ok = True
    summary = {}
    for name in runs[0][1]["outputs"]:
        outs = [r["outputs"][name] for _, r in runs]
        ms = [r["ms"][name] for _, r in runs]
        across = same(outs[0], outs[1]) and same(outs[3], outs[2])
        within = same(outs[1], outs[2]) and same(outs[0], outs[3])
        ok = ok and across and within
        summary[name] = dict(ms=ms, base_equals_head=across, turns_agree=within)
        print(f"[compare] {name}: base {ms[0]:.4f} / {ms[3]:.4f} ms, head {ms[1]:.4f} / "
              f"{ms[2]:.4f} ms; base == head bit for bit: {across}; each tree's two turns "
              f"equal: {within}")
    line = json.dumps({"ok": ok, "device": smi, "cases": summary})
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as fh:
        fh.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
