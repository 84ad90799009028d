#!/usr/bin/env python3
"""Time the paged decode attention and int8 matvec kernels of one or more
source trees on one CUDA card, in turns.

    python3 tools/decode_kernels_bench.py [--tree DIR ...] [--sweep] [--others] [--fp32]
                                          [--only KERNEL ...] [--out FILE]

Each ``--tree`` (a checkout of the repository, the directory that holds
``streammind_torch/``; default: this repository) is measured in a process
of its own, in the order given, so ``--tree old --tree . --tree . --tree
old`` runs parent, change, change, parent within one call.  Each process
builds that tree's two kernels and times them with ``chip_smoke.py``'s
cases of this repository: ``paged_decode_attention`` at K 1, 4 and 8 over
``PAGED_LENGTHS`` and at the serving phase's K = 3 lengths, and
``int8_matvec`` at ``INT8_SHAPES`` for B 1, 4 and 8 (bf16 x; fp32 x with
``--fp32``), each by CUDA graph replay and eagerly, beside its yardstick
(SDPA over pre-gathered pages, ``F.linear`` on the dequantized weight) and
its bound.  With ``--sweep`` a tree whose paged wrapper has ``_span`` is
also timed at each span in ``SPANS``, and one whose int8 wrapper has
``_row_tiles`` at each block height in ``ROW_TILES`` (bf16, B 1 and 8).
With ``--others`` it times instead, the same two ways, the int4 matvec
(``chip_smoke.py``'s ``int4_cases``: bf16 x, fp32 too with ``--fp32``; with
``--sweep`` also at each grid of ``INT4_GRIDS``), a
decode step's token write and paged attention at ``PAGED_WRITE_LENGTHS``
(one launch where the tree folds the write into the attention, else the
write kernel then the attention; beside it the write-free attention alone)
and the selective scan at ``chip_smoke.py``'s ``SCAN_CASES``.  It prints
one line per tree and case and, given ``--out FILE``, writes them all there
as JSON lines.  Fails without a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# the lengths paged_decode_attention is given in the first lockstep step of
# chip_smoke.py's serving phase (its K = 3 turn)
SERVING_LENGTHS = [37, 37, 37]
SPANS = (128, 256, 512)
ROW_TILES = (1, 2, 4, 8)
# (tiles a warp, warps splitting a tile's columns); two tiles a warp from B 3
INT4_GRIDS = [(tw, wk) for tw in (1, 2) for wk in (8, 4, 2, 1)]


def harness(tree: Path):
    """This repository's chip_smoke.py as a module, with ``tree`` first on
    the path, so that the cases come from here and the kernels from there."""
    import importlib.util

    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("decode_bench_cases", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def measure(tree: Path, sweep: bool, fp32: bool) -> list:
    cs = harness(tree)
    import torch

    from streammind_torch.ops import _build
    from streammind_torch.ops import int8_matvec as I8
    from streammind_torch.ops import paged_attention as PA

    if not torch.cuda.is_available():
        raise SystemExit("decode_kernels_bench: no CUDA device")
    assert Path(PA.__file__).resolve().is_relative_to(tree.resolve()), PA.__file__
    _build.build_all(["paged_attention", "int8_matvec"])
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.empty(shape, device=dev, dtype=torch.bfloat16).normal_(generator=g)

    rows = []
    pool_k, pool_v = cs.paged_pool(randn)
    spans = (None,) + (SPANS if sweep and hasattr(PA, "_span") else ())
    default = getattr(PA, "_span", None)
    for span in spans:
        if span is not None:
            PA._span = lambda rows, width, device, span=span: span
        for lengths in [cs.PAGED_LENGTHS[:k] for k in (1, 4, 8)] + [SERVING_LENGTHS]:
            c = cs.paged_attention_case(dev, randn, pool_k, pool_v, lengths)
            rows.append(dict(kernel="paged_attention", span=span, **c))
    if default is not None:
        PA._span = default
    del pool_k, pool_v
    torch.cuda.empty_cache()
    dtypes = (torch.bfloat16, torch.float32) if fp32 else (torch.bfloat16,)
    for c in cs.int8_cases(dev, g, dtypes=dtypes):
        rows.append(dict(kernel="int8_matvec", **c))
    if sweep and hasattr(I8, "_row_tiles"):
        default = I8._row_tiles
        for rt in ROW_TILES:
            I8._row_tiles = lambda dout, device, rt=rt: rt
            for c in cs.int8_cases(dev, g, dtypes=(torch.bfloat16,), batches=(1, 8)):
                rows.append(dict(kernel="int8_matvec", row_tiles=rt, **c))
        I8._row_tiles = default
    return rows


def measure_others(tree: Path, sweep: bool, fp32: bool, only=None) -> list:
    """The int4 matvec at the gate's four linears (B 1, 4 and 8), a decode
    step's write and attention at ``PAGED_WRITE_LENGTHS`` and the selective
    scan at chip_smoke.py's ``SCAN_CASES``, by graph replay and eagerly, at
    chip_smoke.py's shapes.  With ``sweep`` a tree whose int4 wrapper has
    ``_grid`` is also timed at each (tiles a warp, warps a tile) of
    ``INT4_GRIDS`` (bf16, B 1, 4 and 8).  ``only`` (names of kernels) keeps
    those alone."""
    cs = harness(tree)
    import torch

    from streammind_torch.ops import int4_matvec as I4
    from streammind_torch.ops import paged_attention as PA

    dev, rows = "cuda", []
    g = torch.Generator(device=dev).manual_seed(99)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return torch.empty(shape, device=dev, dtype=dtype).normal_(0.0, std, generator=g)

    def timed(kernel, shape, fns, nbytes, flops, peak, **extra):
        b_ms, b_by = cs.bound(nbytes, flops, peak)
        ms, eager = cs.cuda_ms(fns, graph=True), cs.cuda_ms(fns)
        rows.append(dict(kernel=kernel, shape=shape, ms=ms, eager_ms=eager, bound_ms=b_ms,
                         bound_by=b_by, ms_over_bound=ms / b_ms, **extra))

    def wanted(name):
        return not only or name in only

    dtypes = (torch.bfloat16, torch.float32) if fp32 else (torch.bfloat16,)
    for c in cs.int4_cases(dev, g, dtypes=dtypes) if wanted("int4_matvec") else ():
        rows.append(dict(kernel="int4_matvec", **c))
    if sweep and hasattr(I4, "_grid") and wanted("int4_matvec"):
        default = I4._grid
        for tw, wk in INT4_GRIDS:
            I4._grid = lambda b, dout, sms, tw=tw, wk=wk: (tw, 8 * tw // wk)
            for c in cs.int4_cases(dev, g, dtypes=(torch.bfloat16,),
                                   batches=(1, 4, 8) if tw == 1 else (4, 8)):
                rows.append(dict(kernel="int4_matvec", tiles_a_warp=tw, warps_a_tile=wk, **c))
        I4._grid = default
    pool_k, pool_v = cs.paged_pool(randn)
    hkv, h, d, page, maxp, n_pages = (cs.PAGED_SHAPE[k] for k in ("hkv", "h", "d", "page",
                                                                  "maxp", "n_pages"))
    fused = "k_new" in inspect.signature(PA.paged_decode_attention).parameters
    for lengths in cs.PAGED_WRITE_LENGTHS if wanted("paged_write") else ():
        k = len(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        lens1 = lens + 1  # made once: no op of its own inside the timed calls
        sets = []
        for _ in range(64):  # 64 input sets spread over the pool
            table = ((torch.randperm(n_pages, device=dev)[: k * maxp] + 1)
                     .reshape(k, maxp).to(torch.int32))
            # each row's slot: its table's page, or sink page 0 past the table
            pp = (lens // page).long()
            slot = torch.where(pp < maxp, table.gather(1, pp.clamp(max=maxp - 1)[:, None])[:, 0],
                               0).to(torch.int32)
            sets.append((randn(k, 1, h, d), table, randn(k, hkv, d), randn(k, hkv, d), slot,
                         (lens % page).to(torch.int32)))
        if fused:
            step = [lambda s=s: PA.paged_decode_attention(s[0], pool_k, pool_v, s[1], lens,
                                                          k_new=s[2], v_new=s[3]) for s in sets]
        else:
            def pair(q, table, kn, vn, slot, off):
                PA.write_tokens(pool_k, pool_v, kn, vn, slot, off)
                return PA.paged_decode_attention(q, pool_k, pool_v, table, lens1)

            step = [lambda s=s: pair(*s) for s in sets]
        free = [lambda s=s: PA.paged_decode_attention(s[0], pool_k, pool_v, s[1], lens1)
                for s in sets]
        visible = sum(min(n + 1, maxp * page) for n in lengths)
        timed("paged_write", f"write + attention, lengths={lengths}", step,
              2 * (2 * 2 * k * hkv * d) + 8 * k
              + 2 * (2 * visible * hkv * d + 2 * k * h * d) + 4 * (k + -(-visible // page)),
              4.0 * h * d * visible, cs.BF16_FLOPS, launches=1 if fused else 2,
              write_free_ms=cs.cuda_ms(free, graph=True))
        del sets
    del pool_k, pool_v
    torch.cuda.empty_cache()
    for c in cs.scan_cases(dev, g) if wanted("selective_scan") else ():
        rows.append(dict(kernel="selective_scan", **c))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--others", action="store_true")
    ap.add_argument("--only", action="append", default=None,
                    help="with --others: time this kernel alone (int4_matvec, paged_write, "
                         "selective_scan); repeatable")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        rows = (measure_others(args.one, args.sweep, args.fp32, args.only) if args.others
                else measure(args.one, args.sweep, args.fp32))
        for row in rows:
            print(json.dumps(row), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out or os.devnull, "w") as f:
        for i, tree in enumerate(args.tree or [REPO]):
            cmd = [sys.executable, __file__, "--one", str(tree.resolve())]
            cmd += ["--sweep"] * args.sweep + ["--fp32"] * args.fp32 + ["--others"] * args.others
            cmd += [a for name in args.only or () for a in ("--only", name)]
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if out.returncode:
                sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
                return out.returncode
            for line in out.stdout.splitlines():
                row = dict(run=i, tree=str(tree), card=smi, **json.loads(line))
                f.write(json.dumps(row) + "\n")
                if args.others:
                    extra = "".join(f" {k}={row[k]:.4f}" for k in ("library_ms", "write_free_ms")
                                    if row.get(k) is not None)
                    if "ok" in row:
                        extra += f" ok={row['ok']} err={row['max_abs_err']:.3e}"
                    knob = (f" tiles_a_warp={row['tiles_a_warp']} warps_a_tile="
                            f"{row['warps_a_tile']}" if "warps_a_tile" in row else "")
                    print(f"run {i} {tree} {row['kernel']}{knob} {row['shape']}: ms={row['ms']:.4f} "
                          f"eager={row['eager_ms']:.4f}{extra} bound={row['bound_ms']:.4f} "
                          f"x{row['ms_over_bound']:.2f}", flush=True)
                    continue
                knob = (f"span={row['span']}" if "span" in row
                        else f"row_tiles={row.get('row_tiles')}")
                print(f"run {i} {tree} {row['kernel']} {knob} {row['shape']}: "
                      f"ok={row['ok']} err={row['max_abs_err']:.3e} ms={row['ms']:.4f} "
                      f"eager={row['eager_ms']:.4f} library={row['library_ms']:.4f} "
                      f"(eager {row['library_eager_ms']:.4f}) bound={row['bound_ms']:.4f} "
                      f"x{row['ms'] / row['bound_ms']:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
