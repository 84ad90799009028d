"""The paged KV pool of streammind_torch against streammind_tpu, on the CPU.

Both packages get the same numpy inputs (from a seed) and one tiny tree
(the JAX package's init, carried over with params_from_numpy).  The JAX
token-write kernel runs interpreted, as the JAX package's own tests run
it; its paged attention takes its CPU branch (gather + mha_reference).
The port's wrapper takes its plain version on CPU tensors; a decode step
writes its token and attends in one call (``paged_decode_attention`` with
``k_new``/``v_new``), which is held against JAX's write then attention.
Tolerances: the pool write is a copy, so pools must be bitwise equal;
fp32 attention 1e-5 (sums in another order); whole forwards 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.constants import VIDEO_TOKEN_INDEX
from streammind_tpu.models.meta import SplicePlan, build_splice_plan, init_streammind_params
from streammind_tpu.streaming import StreamMindEngine as JEngine
from streammind_tpu.streaming import paged as jpaged
from streammind_torch import config as tconfig
from streammind_torch.ops import paged_attention as tpa
from streammind_torch.streaming import StreamMindEngine as TEngine
from streammind_torch.streaming import paged as tpaged
from streammind_torch.utils.from_jax import params_from_numpy


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(eos_token_id=2, prefill_buckets=(32, 64))
    return cfg, JEngine(jp, cfg, **kw), TEngine(tp, tconfig.tiny_streammind_config(),
                                                device="cpu", **kw)


def _plan(ids, span, bucket=32):
    plan = build_splice_plan(ids, [len(span)], VIDEO_TOKEN_INDEX, bucket)
    mem_index = plan.mem_index.copy()
    mem_index[plan.use_mem] = np.asarray(span, np.int32)
    return SplicePlan(token_ids=plan.token_ids, mem_index=mem_index, use_mem=plan.use_mem,
                      attn_mask=plan.attn_mask, labels=plan.labels, length=plan.length)


def _memory(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (1, cfg.max_stream_frames, cfg.text.hidden_size)).astype(np.float32)


# ---------------------------------------------------------------------------
# the two kernels' plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page_idx,offset", [
    ([3, 1, 6], [0, 7, 13]),    # three rows, page boundaries and an odd offset
    ([0, 0, 2], [5, 5, 15]),    # two finished rows on one sink slot
])
def test_write_tokens_ref_bitwise_matches_jax(rng, page_idx, offset):
    hkv, pages, page, d, k = 2, 7, 16, 32, 3
    pool_k = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    pool_v = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    k_tok = rng.standard_normal((k, hkv, d)).astype(np.float32)
    v_tok = rng.standard_normal((k, hkv, d)).astype(np.float32)
    pi, off = np.asarray(page_idx, np.int32), np.asarray(offset, np.int32)
    jk, jv = jpaged._write_tokens_dma(jnp.asarray(pool_k), jnp.asarray(pool_v),
                                      jnp.asarray(k_tok), jnp.asarray(v_tok),
                                      jnp.asarray(pi), jnp.asarray(off))
    tk, tv = _t(pool_k), _t(pool_v)
    out = tpa.write_tokens_ref(tk, tv, _t(k_tok), _t(v_tok), _t(pi), _t(off))
    assert out[0] is tk and out[1] is tv                  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    untouched = np.ones((pages, page), bool)
    untouched[pi, off] = False
    np.testing.assert_array_equal(tk.numpy()[:, untouched], pool_k[:, untouched])


def test_write_block_routes_out_of_table_rows_to_the_sink(rng):
    """A finished row at its frozen length past its table, or in a
    zero-padded table entry, writes sink page 0 only — as in the JAX
    package (tests/test_paged.py).  The port writes a decode step's token
    in ``paged_decode_attention``, the S = 1 path of its forward."""
    hkv, pages, page, d = 2, 8, 8, 16
    pool = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    table = np.asarray([[5, 2, 0, 0], [1, 3, 4, 7]], np.int32)
    k_new = rng.standard_normal((2, 1, hkv, d)).astype(np.float32)
    q = rng.standard_normal((2, 1, 2 * hkv, d)).astype(np.float32)
    for length in ([4 * page, 4 * page + 3], [2 * page, 31]):
        ln = np.asarray(length, np.int32)
        jk, _ = jpaged._write_block(jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(k_new),
                                    jnp.asarray(k_new), jnp.asarray(table), jnp.asarray(ln),
                                    page)
        tk, tv = _t(pool), _t(pool)
        tpa.paged_decode_attention(_t(q), tk, tv, _t(table), _t(ln), k_new=_t(k_new[:, 0]),
                                   v_new=_t(k_new[:, 0]))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        changed = np.where(np.any(tk.numpy() != pool, axis=(0, 2, 3)))[0]
        assert set(changed.tolist()) <= {0, 7}  # the sink, or row 1's last real page


@pytest.mark.parametrize("lengths,frozen", [
    ([5, 20, 9], False),        # rows inside their tables, one at a page boundary
    ([5, 32, 17], False),       # a row at its table's edge: its token goes to the sink
    ([31, 12, 32], True),       # finished rows at frozen lengths, written twice
])
def test_fused_write_and_attend_matches_jax_write_then_attend(rng, lengths, frozen):
    """paged_decode_attention with k_new/v_new (its plain version on the
    CPU) against JAX's decode step in a layer: ``_write_block`` (S = 1, the
    interpreted token-write kernel), then ``_paged_decode_attention`` at
    length + 1.  Pools bitwise, outputs 1e-5.  ``frozen`` runs the step
    twice at the same lengths, as the lockstep loop does for rows that have
    finished."""
    h, hkv, pages, page, d, maxp = 8, 2, 14, 8, 32, 4
    k = len(lengths)
    pool_k = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    pool_v = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, pages))[:maxp] for _ in range(k)]).astype(
        np.int32)
    ln = np.asarray(lengths, np.int32)
    jk, jv, tk, tv = jnp.asarray(pool_k), jnp.asarray(pool_v), _t(pool_k), _t(pool_v)
    for _ in range(1 + frozen):
        q = rng.standard_normal((k, 1, h, d)).astype(np.float32)
        k_new, v_new = (rng.standard_normal((k, 1, hkv, d)).astype(np.float32) for _ in range(2))
        jk, jv = jpaged._write_block(jk, jv, jnp.asarray(k_new), jnp.asarray(v_new),
                                     jnp.asarray(table), jnp.asarray(ln), page)
        ref = jpaged._paged_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(table),
                                             jnp.asarray(ln + 1))
        out = tpa.paged_decode_attention(_t(q), tk, tv, _t(table), _t(ln),
                                         k_new=_t(k_new[:, 0]), v_new=_t(v_new[:, 0]))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if 32 in lengths:  # the edge row wrote the sink page and nothing of its own
        assert not np.array_equal(tk.numpy()[:, 0], pool_k[:, 0])


@pytest.mark.parametrize("h,hkv,lengths", [
    (4, 2, [5, 32, 17]),        # GQA, ragged, one row filling its table
    (8, 2, [1, 9, 33]),         # group of 4 (Mistral's), one row past its table
    (4, 4, [16, 8, 24]),        # MHA, page boundaries
])
def test_paged_decode_attention_ref_matches_jax(rng, h, hkv, lengths):
    pages, page, d, maxp = 12, 8, 32, 4
    k = len(lengths)
    pool_k = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    pool_v = rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
    q = rng.standard_normal((k, 1, h, d)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, pages))[:maxp] for _ in range(k)]).astype(
        np.int32)
    ln = np.asarray(lengths, np.int32)
    ref = jpaged._paged_decode_attention(jnp.asarray(q), jnp.asarray(pool_k),
                                         jnp.asarray(pool_v), jnp.asarray(table),
                                         jnp.asarray(ln))
    out = tpa.paged_decode_attention(_t(q), _t(pool_k), _t(pool_v), _t(table), _t(ln))
    assert out.shape == (k, 1, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the forward over the pool, and the dialogues
# ---------------------------------------------------------------------------
def test_paged_text_forward_matches_jax(engines, rng):
    """A 13-token prefill block (crossing page boundaries at page 8), then
    two decode steps, through both packages' pools."""
    cfg, jeng, teng = engines
    tcfg = cfg.text
    jpool = jpaged.init_page_pool(tcfg, 9, 8, jnp.float32)
    tpool = tpaged.init_page_pool(teng.cfg.text, 9, 8, torch.float32, device="cpu")
    table = np.asarray([[4, 7, 2, 0], [1, 8, 3, 5]], np.int32)
    ln = np.asarray([3, 0], np.int32)
    x = rng.standard_normal((2, 13, tcfg.hidden_size)).astype(np.float32)
    blocks = [dict(inputs_embeds=x)] + [
        dict(input_ids=rng.integers(3, tcfg.vocab_size, (2, 1)).astype(np.int32))
        for _ in range(2)]
    for blk in blocks:
        jl, jpool = jpaged.paged_text_forward(jeng.params["text"], tcfg, jpool,
                                              jnp.asarray(table), jnp.asarray(ln),
                                              **{k: jnp.asarray(v) for k, v in blk.items()})
        tl, tpool = tpaged.paged_text_forward(
            teng.params["text"], teng.cfg.text, tpool, _t(table), _t(ln),
            **{k: _t(v).long() if k == "input_ids" else _t(v) for k, v in blk.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        ln = ln + next(iter(blk.values())).shape[1]
    for side in ("k", "v"):
        for jl_, tl_ in zip(getattr(jpool, side), getattr(tpool, side)):
            np.testing.assert_allclose(tl_.numpy()[:, 1:], np.asarray(jl_)[:, 1:],
                                       rtol=1e-4, atol=1e-4)


def test_paged_dialogues_match_jax_over_two_turns(engines):
    """page_size 8: page boundaries fall inside both the prefill block and
    the decode loop.  One dialogue turn by turn (run_turn), then three
    dialogues batched over two rounds (run_turns, ragged limits)."""
    cfg, jeng, teng = engines
    plans1 = [_plan([1, 5, 9, VIDEO_TOKEN_INDEX, 7, 4], [0, 1, 2]),
              _plan([1, 8, VIDEO_TOKEN_INDEX, 6], [1, 2]),
              _plan([1, VIDEO_TOKEN_INDEX, 13], [0])]
    plans2 = [_plan([2, 20, VIDEO_TOKEN_INDEX, 21], [3, 4])] * 3
    mems = [_memory(cfg, s) for s in range(3)]
    jpd = jpaged.PagedDialogues(jeng, num_pages=48, page_size=8)
    tpd = tpaged.PagedDialogues(teng, num_pages=48, page_size=8)
    for pd in (jpd, tpd):
        for i in range(4):
            pd.open(f"d{i}")
    for plan in (plans1[0], plans2[0]):
        jt = jpd.run_turn("d3", plan, jnp.asarray(mems[0]), max_new_tokens=6)
        tt = tpd.run_turn("d3", plan, _t(mems[0]), max_new_tokens=6)
        assert tt == jt and tt
        assert tpd.lengths["d3"] == jpd.lengths["d3"]
    dids = ["d0", "d1", "d2"]
    for plans, limits in ((plans1, [5, 3, 6]), (plans2, 4)):
        jt = jpd.run_turns(dids, plans, [jnp.asarray(m) for m in mems], max_new_tokens=limits)
        tt = tpd.run_turns(dids, plans, [_t(m) for m in mems], max_new_tokens=limits)
        assert tt == jt and all(tt)
        assert tpd.lengths == jpd.lengths and tpd.tables == jpd.tables


def test_paged_pool_exhaustion_and_reclaim(engines):
    cfg, _, teng = engines
    pd = tpaged.PagedDialogues(teng, num_pages=4, page_size=8)
    assert 0 not in pd._free and pd.pool.num_pages == 5  # sink page 0 is extra
    pd.open("a")
    pd.ensure_capacity("a", 20)
    assert len(pd.tables["a"]) == 3 and pd.free_pages() == 1
    pd.open("b")
    with pytest.raises(tpaged.PagePoolExhausted):
        pd.ensure_capacity("b", 9)
    pd.close("a")
    pd.ensure_capacity("b", 9)
    assert pd.free_pages() == 2
    with pytest.raises(ValueError, match="multiple of 8"):
        tpaged.init_page_pool(teng.cfg.text, 4, 12, device="cpu")
