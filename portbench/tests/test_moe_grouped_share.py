"""``metrics/moe.grouped_share.py`` on counters worked by hand, on the CPU:

    python -m pytest portbench/tests/test_moe_grouped_share.py -q
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace as NS

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import harness  # noqa: E402


def _share(counts):
    run = NS(trace=None, program=([], counts))
    return harness.load_module(HERE.parent, "metrics", "moe.grouped_share").read(run)


def test_grouped_share_by_hand():
    # three prefills of Mixtral's 32 MoE layers on the grouped form, one on the dense
    assert _share({"moe.grouped_int4": 96, "moe.dense": 32}) == 0.75
    assert _share({"moe.grouped_int4": 48, "int4_grouped_gemm.launches": 96}) == 1.0
    assert _share({"moe.dense": 16}) == 0.0
    # a program that counts neither (one without the grouped form), or a window
    # without a prefill: left out
    assert _share({"int4_matvec.launches": 640}) is None
    assert _share({}) is None
