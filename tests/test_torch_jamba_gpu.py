"""The hybrid (Jamba) decoder's paged path on the card.

Imports torch only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_jamba_gpu.py -q

Every test is marked ``gpu`` and skips without a CUDA device.  On the
small int4 Jamba of tests/test_torch_jamba.py (bf16 activations, head dim
64, 8 experts): a decode step replayed from its CUDA graphs gives the eager
step's logits and states bitwise (the same kernels on the same inputs); a
row that has finished leaves its slot's state bitwise as it was through
the replayed steps; and the scan kernel at a prefill's shapes (B = K,
d_inner 8192, L = a bucket, a carried h0, dt at -inf on the pads) matches
its plain version within the scan tests' limits (bf16 y 4e-3 + 1e-2·|ref|,
the fp32 state 1e-4: both sum in fp32 in another order and round y once).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


def _small_hybrid():
    import test_torch_jamba as J
    from streammind_torch.utils.quantize import quantize_text_params

    cfg = J.hybrid_config(small=True)
    params = quantize_text_params(J.hybrid_params(cfg), bits=4, scheme="pc")

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        keep = key in ("scale", "A_log", "D") or not tree.is_floating_point()
        return (tree if keep else tree.to(torch.bfloat16)).to("cuda")

    params = cast(params)
    return J, cfg, J.paged(cfg, params, "cuda", torch.bfloat16, num_pages=96, page_size=16)


def _prefilled(J, cfg, pd, K, seed=0):
    rng = np.random.default_rng(seed)
    dids = [f"d{r}" for r in range(K)]
    for d in dids:
        pd.open(d)
    mem = torch.randn((1, 6, cfg.hidden_size), device="cuda", dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        pd.run_turns(dids, J.plans_for(rng, K, 16, cfg.vocab_size), [mem] * K,
                     max_new_tokens=0)
    for d in dids:
        pd.ensure_capacity(d, 40)
    return dids, rng.integers(3, cfg.vocab_size, K).tolist()


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_replayed_hybrid_step_is_the_eager_step(dev, K):
    """Four decode steps of K rows (row 0 finished from the third, its row
    routed to the sink slot): each step's logits through the decode step
    (the first eager and captured, the rest replayed) are the eager
    forward's from the same states, bitwise, and so are the states it
    leaves in every dialogue's slot."""
    J, cfg, pd = _small_hybrid()
    dids, toks = _prefilled(J, cfg, pd, K)
    table = pd._table(dids)
    lengths = [pd.lengths[d] for d in dids]
    pd._turn_slots = [pd.slots[d] for d in dids]
    live = slice(1, None)   # the sink's rows may take either finished row's write
    with torch.no_grad():
        for i in range(4):
            slots = [0 if (r == 0 and i >= 2 and K > 1) else s
                     for r, s in enumerate(pd._turn_slots)]
            pd._step_slots = torch.tensor(slots, device=dev)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            ids = torch.tensor(toks, device=dev)[:, None]
            saved = (pd.states.conv.clone(), pd.states.ssm.clone())
            eager = pd._forward(table, lens, ids)
            want = (pd.states.conv.clone(), pd.states.ssm.clone())
            pd.states.conv.copy_(saved[0])
            pd.states.ssm.copy_(saved[1])
            graphed = pd._decode_step(table, lens, toks)
            assert torch.equal(graphed, eager), i
            assert torch.equal(pd.states.conv[:, live], want[0][:, live]), i
            assert torch.equal(pd.states.ssm[:, live], want[1][:, live]), i
            toks = graphed.argmax(-1).tolist()
            lengths = [n + (s != 0) for n, s in zip(lengths, slots)]
    assert list(pd._graphs) == [K]
    assert len(pd._graphs[K].graphs) == sum(cfg.is_moe(i) for i in range(cfg.num_layers)) + 1


def test_finished_rows_keep_their_state_through_replays(dev):
    """A batched turn of three dialogues with limits 2, 9 and 5 on the
    card, its steps replayed from graphs: after each row finishes, its
    slot's conv window and SSM state stay bitwise as they were."""
    J, cfg, pd = _small_hybrid()
    dids = ["a", "b", "c"]
    for d in dids:
        pd.open(d)
    rng = np.random.default_rng(7)
    mem = torch.randn((1, 6, cfg.hidden_size), device=dev, dtype=torch.bfloat16)
    snaps = []
    inner = type(pd)._decode_step

    def step(self, table, length, toks):
        ids = torch.tensor([self.slots[d] for d in dids], device=dev)
        snaps.append((self._step_slots.tolist(), self.states.gather(ids)))
        return inner(self, table, length, toks)

    pd._decode_step = step.__get__(pd)
    with torch.no_grad():
        toks = pd.run_turns(dids, J.plans_for(rng, 3, 16, cfg.vocab_size), [mem] * 3,
                            max_new_tokens=[2, 9, 5])
        final = pd.states.gather(torch.tensor([pd.slots[d] for d in dids], device=dev))
    assert len(snaps) >= 3 and pd._graphs
    for r, d in enumerate(dids):
        fed = len(toks[r])
        for i, (slots, _) in enumerate(snaps):
            assert (slots[r] == 0) == (i >= fed), (d, i)
        if fed < len(snaps):
            frozen = snaps[fed][1]
            for _, st in snaps[fed:] + [(None, final)]:
                assert torch.equal(st.conv[:, r], frozen.conv[:, r]), d
                assert torch.equal(st.ssm[:, r], frozen.ssm[:, r]), d


@pytest.mark.parametrize("K,bucket", [(1, 64), (3, 128), (4, 256)])
def test_scan_kernel_at_the_prefill_shapes(dev, K, bucket):
    """The scan kernel over a hybrid prefill's block: K rows of d_inner 8192
    and a bucket of steps, bf16, a carried fp32 h0, each row's pads (past
    its real length) at dt -inf: y and the last state against the plain
    version, and the last state at each row's real length."""
    from streammind_torch.ops import scan as S

    rng = np.random.default_rng(K)
    d, n = 8192, 16

    def r(shape, dtype, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device=dev)

    xz = r((K, bucket, 2 * d), torch.bfloat16)
    x_dbl = r((K, bucket, 8 + 2 * n), torch.bfloat16)
    dt = r((K, bucket, d), torch.bfloat16, 0.5)
    real = torch.tensor(rng.integers(bucket // 2, bucket + 1, K), device=dev)
    pads = torch.arange(bucket, device=dev)[None] >= real[:, None]
    dt = dt.masked_fill(pads[:, :, None], float("-inf"))
    u, z = xz[..., :d].transpose(1, 2), xz[..., d:].transpose(1, 2)
    Bm, Cm = x_dbl[..., 8:8 + n].transpose(1, 2), x_dbl[..., 8 + n:].transpose(1, 2)
    A = -torch.exp(r((d, n), torch.float32, 0.5))
    kw = dict(D=r((d,), torch.float32), z=z, delta_bias=r((d,), torch.float32),
              delta_softplus=True, return_last_state=True, h0=r((K, d, n), torch.float32))
    args = (u, dt.transpose(1, 2), A, Bm, Cm)
    y, h = S.selective_scan_kernel(*args, **kw)
    ref_y, ref_h = S.selective_scan_ref(*args, **kw)
    torch.testing.assert_close(y.float(), ref_y.float(), atol=4e-3, rtol=1e-2)
    torch.testing.assert_close(h, ref_h, atol=1e-4, rtol=1e-4)
    for b in range(K):   # the state at the real length: the pads carried it unchanged
        m = int(real[b])
        kw_b = dict(kw, z=z[b:b + 1, :, :m], h0=kw["h0"][b:b + 1])
        _, h_b = S.selective_scan_ref(u[b:b + 1, :, :m], args[1][b:b + 1, :, :m], A,
                                      Bm[b:b + 1, :, :m], Cm[b:b + 1, :, :m], **kw_b)
        torch.testing.assert_close(h[b:b + 1], h_b, atol=1e-4, rtol=1e-4)
