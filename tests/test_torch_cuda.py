"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where no CUDA device is visible and run with
``python -m pytest -m gpu tests/test_torch_cuda.py`` on a machine with an
H100 and ``nvcc`` (the kernels build at first use). This file imports no
JAX, so it runs where only PyTorch is installed. Tolerances: fp32 rmsnorm
1e-5 in all three forms (the residual sum itself equal to the eager add),
fp32 attention, decode scores and decode stats 1e-4 (the kernels sum in
another order; decode stats' fp32 outputs 1e-4 for bf16 V too, the masked
scores exactly NEG_INF, two calls bitwise equal); bf16 outputs 2e-2 (one
bf16 ulp at 4 is 1.6e-2); the two decode kernels at a sequence-parallel
shard's slot offset as their plain versions, a shard with no slot kept
giving m = NEG_INF, o = 0 and l = 0 exactly, also at a tensor-parallel
rank's heads (KV = 4, G = 3), and qwen2-moe-a2.7b's shapes (16 q and 16
KV heads of 128, norms 2,048 wide); the decode step's CUDA graph
replay bitwise equal
to the eager forward on a copy of the cache, the MoE decoder's (its
dispatch tables, expert products and combine inside the graph) too; the
DMA allgather
copies bytes and is held equal; the SSD scan (fp32 output whatever its
input dtype, held against the plain version on the same inputs) max |y -
y_ref| / max |y_ref| < 1e-4 and max |h - h_ref| / max |h_ref| < 1e-4, the chunk
invariance bound of ``tests/test_kernels.py`` (the kernel chunks by 64,
the plain version by Q); the SSD backward and the gated RMSNorm backward
at the tolerances stated where their cases are (``SSD_BWD_REL``); the
gated RMSNorm split over a model tier (its four launches, the tier's sums
emulated) against the unsplit plain forward and backward; the dense
variants' instances: flash at head dim 120 (in the D = 128 instance) and
gemma2's D = 256 with window and cap, the two decode kernels over a ring
cache at positions before, at and past its wrap and on each shard of a
ring split over ranks (``slot_offset``, ``total_len``), and the decode graph of
h2o-danube and gemma2 (a 16-slot ring that the requests wrap) bitwise the
eager forward, its launches counted with the ring instances apart;
llama4-scout's: the two decode kernels over a chunked ring (the kept
slots [0, pos mod chunk]) and each shard of one, and RMSNorm at qk-norm's
rows (B, S, heads, 128).
"""
import pytest
import torch

from repro_torch.kernels.decode_stats import ops as stats_ops
from repro_torch.kernels.dma_allgather import ops as dma_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import checks as ssd_checks
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import attention as tattention

FLASH_CASES = [
    # (B, S, T, H, KV, D, mask)
    (2, 64, 64, 4, 2, 32, dict(causal=True)),
    (1, 48, 48, 4, 4, 32, dict(causal=False)),
    (1, 64, 64, 6, 2, 64, dict(causal=True, window=16)),
    (1, 64, 64, 4, 1, 32, dict(causal=True, chunk=16)),
    (1, 40, 40, 4, 2, 32, dict(causal=True, cap=30.0)),
    (1, 37, 37, 4, 2, 32, dict(causal=True, window=8, cap=50.0)),
    (2, 23, 41, 8, 2, 32, dict(causal=False)),          # ragged S != T
    (1, 29, 29, 3, 1, 64, dict(causal=True)),           # GQA G=3, odd S
    (1, 137, 137, 24, 8, 128, dict(causal=True)),       # llama3.2-3b heads
    (1, 100, 100, 4, 2, 256, dict(causal=True)),
    # the bf16 kernel's 64-row q and 64-key kv tiles: lengths at their
    # edges, G = 1, 3 and 8, S != T, and every mask at D = 64 and D = 128
    (1, 1, 1, 8, 8, 128, dict(causal=True)),            # G = 1, one token
    (1, 63, 63, 24, 8, 128, dict(causal=True)),         # G = 3
    (1, 64, 64, 8, 1, 128, dict(causal=True)),          # G = 8
    (2, 65, 65, 6, 2, 64, dict(causal=True)),
    (1, 127, 127, 8, 8, 64, dict(causal=True)),
    (1, 129, 129, 16, 2, 128, dict(causal=True)),
    (1, 512, 512, 24, 8, 128, dict(causal=True)),       # the main path
    (1, 100, 260, 24, 8, 128, dict(causal=False)),      # S != T
    (1, 300, 300, 8, 2, 64, dict(causal=True, window=64)),
    (1, 300, 300, 8, 2, 128, dict(causal=True, window=100)),
    (1, 257, 257, 6, 2, 64, dict(causal=True, chunk=128)),
    (1, 300, 300, 24, 8, 128, dict(causal=True, chunk=128)),
    (1, 200, 200, 4, 1, 64, dict(causal=True, cap=30.0)),
    (1, 190, 190, 24, 8, 128, dict(causal=True, cap=50.0)),
    (1, 137, 137, 16, 16, 128, dict(causal=True)),     # qwen2-moe heads
    (1, 512, 512, 16, 16, 128, dict(causal=True)),
    # the dense variants: h2o-danube's D = 120 (in the D = 128 instance,
    # the tensor maps ending at 120), gemma2's D = 256 with window and cap
    (1, 512, 512, 32, 8, 120, dict(causal=True, window=4096)),
    (1, 137, 137, 32, 8, 120, dict(causal=True, window=64)),
    (2, 65, 65, 8, 2, 120, dict(causal=True, window=24, cap=50.0)),
    (1, 100, 260, 4, 1, 120, dict(causal=False)),
    (1, 300, 300, 16, 8, 256, dict(causal=True, window=128, cap=50.0)),
]


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype, fp32_tol):
    tol = fp32_tol if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 3072), (37, 100), (2, 5, 128),
                                   (3, 7, 40, 128), (3, 7, 8, 128)])
def test_rmsnorm_kernel_on_card(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    sc = (torch.randn(shape[-1], generator=g, device=cuda) * 0.2).to(dtype)
    before = rms_ops.LAUNCHES
    out = rms_ops.rmsnorm(x, sc)
    torch.cuda.synchronize()
    assert rms_ops.LAUNCHES == before + 1
    _close(out, rms_ops.rmsnorm_ref(x, sc), dtype, 1e-5)


# (rows, d, offset): the serving widths (llama3.2-3b 3072, mamba2-780m's
# layer norm 1536 and gate 3072) at decode and prefill rows, an odd d and a
# row start one element past 16 bytes (both take the scalar loop)
RMS_FORM_CASES = [(8, 3072, 0), (512, 3072, 0), (8, 1536, 0), (37, 1536, 0),
                  (5, 37, 0), (4, 256, 1), (8, 2048, 0), (512, 2048, 0)]


def _rms_inputs(rows, d, offset, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=device)
    a = rn(rows * d + offset)[offset:].reshape(rows, d)
    b = rn(rows * d + offset)[offset:].reshape(rows, d)
    return a, b, (rn(d) * 0.2).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RMS_FORM_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_rmsnorm_residual_kernel_on_card(cuda, dtype, case):
    a, b, sc = _rms_inputs(*case, dtype, cuda, 5)
    x, delta = (a * 3).to(dtype), b.to(dtype)
    before = (rms_ops.LAUNCHES, rms_ops.FORM_LAUNCHES["residual"])
    s, y = rms_ops.rmsnorm_residual(x, delta, sc)
    torch.cuda.synchronize()
    assert (rms_ops.LAUNCHES, rms_ops.FORM_LAUNCHES["residual"]) == (
        before[0] + 1, before[1] + 1)
    rs, ry = rms_ops.rmsnorm_residual_ref(x, delta, sc)
    assert torch.equal(s, rs)                     # one rounded add, as eager
    _close(y, ry, dtype, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RMS_FORM_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_rmsnorm_gated_kernel_on_card(cuda, dtype, case):
    rows, d, offset = case
    a, b, sc = _rms_inputs(rows, d, offset, dtype, cuda, 6)
    # z as the mixer gives it: the first d columns of a wider projection
    wide = torch.zeros((rows, d + 64 + offset), device=cuda, dtype=dtype)
    wide[:, offset:offset + d] = (b * 2).to(dtype)
    z = wide[:, offset:offset + d]
    before = (rms_ops.LAUNCHES, rms_ops.FORM_LAUNCHES["gated"])
    out = rms_ops.rmsnorm_gated(a, z, sc)
    torch.cuda.synchronize()
    assert (rms_ops.LAUNCHES, rms_ops.FORM_LAUNCHES["gated"]) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and out.shape == (rows, d)
    _close(out, rms_ops.rmsnorm_gated_ref(a, z, sc), dtype, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_on_card(cuda, dtype, case):
    B, S, T, H, KV, D, mask = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype)
    before = flash_ops.LAUNCHES, flash_ops.D120_LAUNCHES
    out = flash_ops.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert (flash_ops.LAUNCHES, flash_ops.D120_LAUNCHES) == \
        (before[0] + 1, before[1] + (D == 120))
    _close(out, flash_ops.attention_ref(q, k, v, **mask), dtype, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(8, 24, 8, 128, 1024), (3, 4, 2, 32, 200)])
def test_decode_stats_kernel_on_card(cuda, dtype, dims):
    B, H, KV, D, L = dims
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, 1, H, D), generator=g, device=cuda)
    k = torch.randn((B, L, KV, D), generator=g, device=cuda)
    v = torch.randn((B, L, KV, D), generator=g, device=cuda).to(dtype)
    pos = torch.randint(0, L, (B,), generator=g, device=cuda)
    s, _ = tattention.decode_stats_scores(q, k, pos)
    s[0] = tattention.NEG_INF                       # one fully masked row
    m = s.amax(-1)
    before = stats_ops.LAUNCHES
    o, l = stats_ops.accumulate(s, m, v)
    torch.cuda.synchronize()
    assert stats_ops.LAUNCHES == before + 1
    ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
    torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


# (B, KV, G, D, L): the llama3.2-3b decode shape; every head count and head
# dim the decode kernels take (G 1-8, D a multiple of 8 up to 256: 64, 120,
# 128, 256 and 8); L = 1 and lengths that are no multiple of a tile
DECODE_CASES = [(8, 8, 3, 128, 1024), (3, 2, 1, 64, 200), (2, 2, 4, 120, 75),
                (2, 2, 5, 128, 130), (2, 1, 6, 128, 64), (2, 2, 8, 128, 97),
                (2, 2, 2, 256, 300), (3, 2, 7, 8, 33), (2, 2, 3, 128, 1),
                (8, 16, 1, 128, 1024)]                # qwen2-moe's decode
DECODE_MASKS = [{}, dict(window=48), dict(chunk=64), dict(cap=30.0),
                dict(window=20, chunk=32, cap=20.0)]


def _decode_tensors(case, dtype, device, seed=3):
    B, KV, G, D, L = case
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=device)
    return (rn(B, 1, KV * G, D).to(dtype), rn(B, L, KV, D).to(dtype),
            rn(B, L, KV, D).to(dtype))


def _edge_positions(B, L, device):
    """Per-row positions on the edges of the kernels' pieces and splits
    (0, 31/32, 63/64, 127/128) and the last slot, clipped to the cache."""
    edges = [L - 1, 0, 31, 32, 63, 64, 127, 128]
    return torch.tensor([min(L - 1, edges[i % len(edges)]) for i in range(B)],
                        device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", DECODE_MASKS, ids=str)
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_scores_kernel_on_card(cuda, dtype, mask, case):
    B, KV, G, D, L = case
    q, k, _ = _decode_tensors(case, dtype, cuda)
    for pos in (_edge_positions(B, L, cuda),
                torch.tensor(L // 2, device=cuda)):      # one for every row
        before = stats_ops.SCORES_LAUNCHES
        s, m = stats_ops.decode_scores(q, k, pos, **mask)
        torch.cuda.synchronize()
        assert stats_ops.SCORES_LAUNCHES == before + 1
        rs, rm = stats_ops.decode_scores_ref(q, k, pos, **mask)
        masked = rs == tattention.NEG_INF
        assert torch.equal(s == tattention.NEG_INF, masked)
        _close(s, rs, dtype, 1e-4)
        _close(m, rm, dtype, 1e-4)


# (B, KV, G, D, L) of a ring cache (L slots, window W >= L): h2o-danube's
# decode (G = 4, D = 120), gemma2's (G = 2, D = 256) and a ragged L
RING_CASES = [(8, 8, 4, 120, 64), (2, 8, 2, 256, 64), (3, 2, 3, 128, 75)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [dict(), dict(cap=50.0)], ids=str)
@pytest.mark.parametrize("case", RING_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_kernels_on_a_ring(cuda, dtype, mask, case):
    """Both decode kernels over a ring cache, at positions before, at and
    past the wrap (per row, and one for every row), against their plain
    versions (the JAX ring mask: slot j holds token pos - ((pos - j) mod
    L)); the kept slots are [0, min(pos, L - 1)]."""
    B, KV, G, D, L = case
    q, k, v = _decode_tensors(case, dtype, cuda)
    W = L + 7                                # any window >= the ring
    wraps = [L - 2, L - 1, L, 3 * L + 5, 5, 2 * L - 1, L + 1, 0]
    for pos in (torch.tensor([wraps[i % len(wraps)] for i in range(B)],
                             device=cuda),
                torch.tensor(4 * L + 3, device=cuda)):
        n = (stats_ops.SCORES_LAUNCHES, stats_ops.RING_SCORES_LAUNCHES,
             stats_ops.LAUNCHES, stats_ops.RING_LAUNCHES)
        s, m = stats_ops.decode_scores(q, k, pos, window=W, ring=True,
                                       **mask)
        o, l = stats_ops.accumulate(s, m, v, pos=pos, window=W, ring=True)
        torch.cuda.synchronize()
        assert (stats_ops.SCORES_LAUNCHES, stats_ops.RING_SCORES_LAUNCHES,
                stats_ops.LAUNCHES, stats_ops.RING_LAUNCHES) == \
            tuple(c + 1 for c in n)
        rs, rm = stats_ops.decode_scores_ref(q, k, pos, window=W, ring=True,
                                             **mask)
        kept = (rs != tattention.NEG_INF)[:, 0, 0]
        want = torch.arange(L, device=cuda)[None] <= \
            pos.expand(B)[:, None].clamp(max=L - 1)
        assert torch.equal(kept, want)
        assert torch.equal(s == tattention.NEG_INF, rs == tattention.NEG_INF)
        _close(s, rs, dtype, 1e-4)
        _close(m, rm, dtype, 1e-4)
        ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
        torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="ring"):
        stats_ops.decode_scores(q, k, pos, window=L - 1, ring=True)
    with pytest.raises(ValueError, match="ring"):
        stats_ops.accumulate(s, m, v, pos=pos, chunk=16, ring=True)


# a ring split over ranks (a model rank's KV = 4): gemma2's tier decode
# shape (G = 2, D = 256, cap 50) and h2o-danube's (G = 4, D = 120), a B = 1
# ring of T = 256 slots in 4 shards of 64 at positions where a shard keeps
# none, part or all of its slots, before, at and past the wrap
RING_SHARD_CASES = [(4, 2, 256, 50.0), (4, 4, 120, 0.0)]
RING_SHARD_T, RING_SHARD_N = 256, 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RING_SHARD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_kernels_on_a_ring_shard(cuda, dtype, case):
    """Both decode kernels on each shard of a ring (``slot_offset``,
    ``total_len``, ``ring``) against their plain versions: global slot j
    holds token pos - ((pos - j) mod T), so a shard at offset off keeps
    its local slots [0, min(pos - off, L - 1)]; a shard that keeps none
    gives m = NEG_INF, o = 0 and l = 0 exactly. Then B = 2 rows over a
    whole ring past its wrap."""
    KV, G, D, cap = case
    T, n = RING_SHARD_T, RING_SHARD_N
    L = T // n
    q, k, v = _decode_tensors((1, KV, G, D, T), dtype, cuda)
    states = set()
    for p_ in (100, T - 6, T + 4, 3 * T + 1):
        pos = torch.tensor(p_, device=cuda)
        for shard in range(n):
            off = shard * L
            kw = dict(slot_offset=off, total_len=T, window=T, ring=True)
            kl, vl = k[:, off:off + L], v[:, off:off + L]       # views
            before = (stats_ops.RING_SCORES_LAUNCHES, stats_ops.RING_LAUNCHES)
            s, m = stats_ops.decode_scores(q, kl, pos, cap=cap, **kw)
            o, l = stats_ops.accumulate(s, m, vl, pos=pos, **kw)
            torch.cuda.synchronize()
            assert (stats_ops.RING_SCORES_LAUNCHES,
                    stats_ops.RING_LAUNCHES) == (before[0] + 1,
                                                 before[1] + 1)
            rs, rm = stats_ops.decode_scores_ref(q, kl, pos, cap=cap, **kw)
            kept = int((rs[0, 0, 0] > tattention.NEG_INF).sum())
            assert kept == (min(max(p_ - off + 1, 0), L) if p_ < T else L)
            assert torch.equal(s == tattention.NEG_INF,
                               rs == tattention.NEG_INF)
            _close(s, rs, dtype, 1e-4)
            _close(m, rm, dtype, 1e-4)
            ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, vl)
            torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
            states.add("none" if kept == 0 else "all" if kept == L
                       else "part")
            if kept == 0:
                assert bool((m == tattention.NEG_INF).all())
                assert float(o.abs().max()) == float(l.abs().max()) == 0.0
    assert states == {"none", "part", "all"}
    q, k, v = _decode_tensors((2, KV, G, D, T), dtype, cuda, seed=4)
    pos = torch.tensor([T + 3, 2 * T - 1], device=cuda)
    kw = dict(total_len=T, window=T, ring=True)
    s, m = stats_ops.decode_scores(q, k, pos, cap=cap, **kw)
    o, l = stats_ops.accumulate(s, m, v, pos=pos, **kw)
    rs, rm = stats_ops.decode_scores_ref(q, k, pos, cap=cap, **kw)
    assert bool((rs > tattention.NEG_INF).all())        # every slot kept
    _close(s, rs, dtype, 1e-4)
    _close(m, rm, dtype, 1e-4)
    ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
    torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


# a chunked ring (llama4-scout's chunked layers): llama4's decode heads
# (KV = 8, G = 5, D = 128) and a small case, a ring of T = chunk = 128
# slots whose positions run through several chunks, and one of T = 96 <
# chunk (a cache shorter than the chunk: positions stay below T)
CHUNK_RING_CASES = [(8, 5, 128), (2, 3, 64)]
CHUNK_RING_C = 128


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CHUNK_RING_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_kernels_on_a_chunked_ring(cuda, dtype, case):
    """Both decode kernels on a chunked ring against their plain versions
    (the JAX ring mask with the chunk test on each slot's token): a whole
    ring keeps the slots [0, min(pos mod chunk, T - 1)], per row and one
    position for every row; each shard of a ring split in four (``
    slot_offset``, ``total_len``) keeps [0, min(pos mod chunk - off, L -
    1)], none where pos mod chunk < off (a shard with no slot kept gives
    m = NEG_INF, o = 0 and l = 0 exactly). The ``RING_*`` counters count
    every launch."""
    KV, G, D = case
    C, n = CHUNK_RING_C, 4
    for T, positions in ((C, [0, 5, C - 1, C, C + 1, 2 * C + 77, 3 * C - 1,
                              5 * C + 40]),
                         (96, [0, 1, 40, 95])):
        B = len(positions)
        q, k, v = _decode_tensors((B, KV, G, D, T), dtype, cuda)
        kw = dict(chunk=C, ring=True)
        for pos in (torch.tensor(positions, device=cuda),
                    torch.tensor(positions[-1], device=cuda)):
            before = (stats_ops.RING_SCORES_LAUNCHES, stats_ops.RING_LAUNCHES)
            s, m = stats_ops.decode_scores(q, k, pos, **kw)
            o, l = stats_ops.accumulate(s, m, v, pos=pos, **kw)
            torch.cuda.synchronize()
            assert (stats_ops.RING_SCORES_LAUNCHES,
                    stats_ops.RING_LAUNCHES) == (before[0] + 1,
                                                 before[1] + 1)
            rs, rm = stats_ops.decode_scores_ref(q, k, pos, **kw)
            kept = (rs != tattention.NEG_INF)[:, 0, 0]
            want = torch.arange(T, device=cuda)[None] <= \
                (pos.expand(B)[:, None] % C).clamp(max=T - 1)
            assert torch.equal(kept, want)
            assert torch.equal(s == tattention.NEG_INF,
                               rs == tattention.NEG_INF)
            _close(s, rs, dtype, 1e-4)
            _close(m, rm, dtype, 1e-4)
            ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
            torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
    q, k, v = _decode_tensors((1, KV, G, D, C), dtype, cuda, seed=5)
    L, states = C // n, set()
    for p_ in (20, 100, C + 2, 3 * C + 50, 4 * C - 1):
        pos = torch.tensor(p_, device=cuda)
        for shard in range(n):
            off = shard * L
            kw = dict(slot_offset=off, total_len=C, chunk=C, ring=True)
            kl, vl = k[:, off:off + L], v[:, off:off + L]       # views
            s, m = stats_ops.decode_scores(q, kl, pos, **kw)
            o, l = stats_ops.accumulate(s, m, vl, pos=pos, **kw)
            rs, rm = stats_ops.decode_scores_ref(q, kl, pos, **kw)
            kept = int((rs[0, 0, 0] > tattention.NEG_INF).sum())
            assert kept == min(max(p_ % C - off + 1, 0), L)
            assert torch.equal(s == tattention.NEG_INF,
                               rs == tattention.NEG_INF)
            _close(s, rs, dtype, 1e-4)
            _close(m, rm, dtype, 1e-4)
            ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, vl)
            torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
            states.add("none" if kept == 0 else "all" if kept == L
                       else "part")
            if kept == 0:
                assert bool((m == tattention.NEG_INF).all())
                assert float(o.abs().max()) == float(l.abs().max()) == 0.0
    assert states == {"none", "part", "all"}


@pytest.mark.gpu
def test_decode_scores_of_a_row_with_no_slot_kept(cuda):
    # row 1 sits past the cache with a window that ends before it
    q, k, _ = _decode_tensors((2, 2, 3, 64, 40), torch.bfloat16, cuda)
    s, m = stats_ops.decode_scores(q, k, torch.tensor([7, 90], device=cuda),
                                   window=16)
    torch.cuda.synchronize()
    assert torch.all(s[1] == tattention.NEG_INF)
    assert torch.all(m[1] == tattention.NEG_INF)
    rs, rm = stats_ops.decode_scores_ref(q, k, torch.tensor([7, 90],
                                                            device=cuda),
                                         window=16)
    _close(s, rs, torch.bfloat16, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", DECODE_MASKS, ids=str)
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_stats_kernel_over_every_head_shape(cuda, dtype, mask, case):
    B, KV, G, D, L = case
    q, k, v = _decode_tensors(case, dtype, cuda)
    pos = _edge_positions(B, L, cuda)
    s, _ = stats_ops.decode_scores_ref(q.float(), k.float(), pos, **mask)
    s[0, 0] = tattention.NEG_INF                 # one fully masked row
    m = s.amax(-1)
    ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
    # without and with the kept-slot hint (the position, window and chunk
    # s was masked with: a kept interval that starts past slot 0 under a
    # window or a chunk)
    hint = dict(pos=pos, window=mask.get("window", 0),
                chunk=mask.get("chunk", 0))
    for hint in ({}, hint):
        before = stats_ops.LAUNCHES
        o, l = stats_ops.accumulate(s, m, v, **hint)
        o2, l2 = stats_ops.accumulate(s, m, v, **hint)
        torch.cuda.synchronize()
        assert stats_ops.LAUNCHES == before + 2
        assert torch.equal(o, o2) and torch.equal(l, l2)   # no atomic adds
        torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
        assert float(o[0, 0, :G].abs().max()) == 0.0
        assert float(l[0, 0, :G].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", DECODE_MASKS, ids=str)
def test_decode_attention_on_card_equals_the_plain_composition(cuda, dtype,
                                                               mask):
    # the decode path's two kernels, then o / l and the cast, against the
    # plain scores, row max, accumulation, o / l and cast on the same inputs
    case = (4, 2, 3, 128, 300)
    B, KV, G, D, L = case
    q, k, v = _decode_tensors(case, dtype, cuda)
    pos = torch.tensor([299, 150, 47, 200], device=cuda)
    before = (stats_ops.SCORES_LAUNCHES, stats_ops.LAUNCHES)
    out = tattention.decode_attention(q, k, v, pos, **mask)
    torch.cuda.synchronize()
    assert (stats_ops.SCORES_LAUNCHES, stats_ops.LAUNCHES) == (before[0] + 1,
                                                               before[1] + 1)
    s, m = stats_ops.decode_scores_ref(q, k, pos, **mask)
    o, l = stats_ops.decode_stats_accumulate_ref(s, m, v)
    ref = (o / l[..., None]).to(dtype)
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, ref, dtype, 1e-4)


@pytest.mark.gpu
def test_decode_kernels_refuse_what_they_do_not_take(cuda):
    B, KV, G, D, L = 2, 2, 2, 64, 40
    q, k, v = _decode_tensors((B, KV, G, D, L), torch.bfloat16, cuda)
    pos = torch.tensor([5, 9], device=cuda)
    s, m = stats_ops.decode_scores_ref(q, k, pos)
    strided = torch.empty((B, KV, L, D), dtype=k.dtype,
                          device=cuda).transpose(1, 2)
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype,
                          device=cuda)[1:].view(k.shape)
    with pytest.raises(ValueError, match="k of shape .* is not contiguous"):
        stats_ops.decode_scores(q, strided, pos)
    with pytest.raises(ValueError, match="k does not start on 16 bytes"):
        stats_ops.decode_scores(q, shifted, pos)
    with pytest.raises(ValueError, match="pos"):
        stats_ops.decode_scores(q, k, pos.int())
    with pytest.raises(TypeError, match="must match"):
        stats_ops.decode_scores(q.float(), k, pos)
    with pytest.raises(ValueError, match="G = 9"):
        stats_ops.decode_scores(torch.zeros((B, 1, 9 * KV, D), dtype=q.dtype,
                                            device=cuda), k, pos)
    with pytest.raises(ValueError, match="D = 12"):
        stats_ops.decode_scores(q[..., :12].contiguous(),
                                k[..., :12].contiguous(), pos)
    with pytest.raises(ValueError, match="v does not start on 16 bytes"):
        stats_ops.accumulate(s, m, shifted)
    with pytest.raises(ValueError, match="s of shape .* is not contiguous"):
        stats_ops.accumulate(s.transpose(2, 3).contiguous().transpose(2, 3),
                             m, v)
    with pytest.raises(ValueError, match="G = 9"):
        stats_ops.accumulate(torch.zeros((B, KV, 9, L), device=cuda),
                             torch.zeros((B, KV, 9), device=cuda), v)


# a sequence-parallel cache of 4 x 50 slots: every shard at positions where
# it keeps all of its slots, part of them or none, under each mask (a chunk
# of 32 that the offsets 50 and 150 do not divide)
SHARD_L, SHARDS = 50, 4
SHARD_POS = [(199, 120, 30, 75), (0, 49, 50, 101)]
SHARD_MASKS = [{}, dict(window=40), dict(chunk=32), dict(window=20, chunk=64,
                                                         cap=30.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("mask", SHARD_MASKS, ids=str)
def test_decode_kernels_at_a_slot_offset(cuda, dtype, G, mask):
    B, KV, D = 4, 2, 64
    q, k, v = _decode_tensors((B, KV, G, D, SHARD_L * SHARDS), dtype, cuda)
    hint = dict(window=mask.get("window", 0), chunk=mask.get("chunk", 0))
    states = set()
    for rows in SHARD_POS:
        pos = torch.tensor(rows, device=cuda)
        for shard in range(SHARDS):
            off = shard * SHARD_L
            kl, vl = (t[:, off:off + SHARD_L].contiguous() for t in (k, v))
            before = (stats_ops.SCORES_LAUNCHES, stats_ops.LAUNCHES)
            s, m = stats_ops.decode_scores(q, kl, pos, slot_offset=off,
                                           **mask)
            o, l = stats_ops.accumulate(s, m, vl, pos=pos, slot_offset=off,
                                        **hint)
            torch.cuda.synchronize()
            assert (stats_ops.SCORES_LAUNCHES, stats_ops.LAUNCHES) == (
                before[0] + 1, before[1] + 1)
            rs, rm = stats_ops.decode_scores_ref(q, kl, pos, slot_offset=off,
                                                 **mask)
            assert torch.equal(s == tattention.NEG_INF,
                               rs == tattention.NEG_INF)
            _close(s, rs, dtype, 1e-4)
            _close(m, rm, dtype, 1e-4)
            ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, vl)
            torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
            kept = (rs > tattention.NEG_INF).sum(-1)[:, 0, 0]
            for b in range(B):
                n = int(kept[b])
                states.add("none" if n == 0 else
                           "all" if n == SHARD_L else "part")
                if n == 0:        # exactly NEG_INF, 0 and 0
                    assert bool((m[b] == tattention.NEG_INF).all())
                    assert float(o[b].abs().max()) == 0.0
                    assert float(l[b].abs().max()) == 0.0
    assert states == {"none", "part", "all"} or mask, states


# one model rank of llama3.2-3b on a tier of 2 (8 KV heads over 2: KV = 4,
# G = 3, D = 128): B_loc = 2 rows of a 2,048-slot cache at positions of a
# batch-sharded trace, and one B = 1 shard of 8,192 slots of a 32,768-slot
# cache at each shard's offset, at positions 3,000 and 11,000 (a shard
# keeps all its slots, part of them or none)
TIER_KV, TIER_G, TIER_D = 4, 3, 128


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_pair_at_a_model_ranks_batch_rows(cuda, dtype):
    B, L = 2, 2048
    q, k, v = _decode_tensors((B, TIER_KV, TIER_G, TIER_D, L), dtype, cuda)
    for rows in ((134, 1521), (700, 2047), (0, 1024)):
        pos = torch.tensor(rows, device=cuda)
        before = (stats_ops.SCORES_LAUNCHES, stats_ops.LAUNCHES)
        s, m = stats_ops.decode_scores(q, k, pos)
        o, l = stats_ops.accumulate(s, m, v, pos=pos)
        out = tattention.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert (stats_ops.SCORES_LAUNCHES, stats_ops.LAUNCHES) == (
            before[0] + 2, before[1] + 2)
        rs, rm = stats_ops.decode_scores_ref(q, k, pos)
        assert torch.equal(s == tattention.NEG_INF, rs == tattention.NEG_INF)
        _close(s, rs, dtype, 1e-4)
        _close(m, rm, dtype, 1e-4)
        ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, v)
        torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
        _close(out, (ro / rl[..., None]).to(dtype), dtype, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_pair_at_a_model_ranks_cache_shard(cuda, dtype):
    L, shards = 8192, 4
    q, k, v = _decode_tensors((1, TIER_KV, TIER_G, TIER_D, L * shards),
                              dtype, cuda)
    states = set()
    for p_ in (3000, 11000):
        pos = torch.tensor(p_, device=cuda)
        for shard in range(shards):
            off = shard * L
            kl, vl = k[:, off:off + L], v[:, off:off + L]       # views
            s, m = stats_ops.decode_scores(q, kl, pos, slot_offset=off)
            o, l = stats_ops.accumulate(s, m, vl, pos=pos, slot_offset=off)
            torch.cuda.synchronize()
            rs, rm = stats_ops.decode_scores_ref(q, kl, pos, slot_offset=off)
            assert torch.equal(s == tattention.NEG_INF,
                               rs == tattention.NEG_INF)
            _close(s, rs, dtype, 1e-4)
            _close(m, rm, dtype, 1e-4)
            ro, rl = stats_ops.decode_stats_accumulate_ref(s, m, vl)
            torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
            n = int((rs[0, 0, 0] > tattention.NEG_INF).sum())
            states.add("none" if n == 0 else "all" if n == L else "part")
            if n == 0:
                assert float(o.abs().max()) == float(l.abs().max()) == 0.0
    assert states == {"none", "part", "all"}


# reduced-depth engines: (prompt length, new tokens, arrival step); the last
# three arrive while earlier rows decode, into rows freed on the way
GRAPH_REQUESTS = [(9, 6, 0.0), (14, 9, 0.0), (5, 4, 2.0), (11, 7, 4.0),
                  (7, 5, 6.0)]


def _small_engine(arch, device):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec, StepClock
    cfg = dataclasses.replace(configs.get_smoke(arch), n_layers=2)
    if cfg.window:          # a 16-slot ring, so that the requests wrap it
        cfg = dataclasses.replace(cfg, window=16)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    eng = Engine(cfg, params, ServeSpec(batch=3, cache_len=64), device=device,
                 clock=StepClock())
    g = torch.Generator().manual_seed(1)
    for n, m, t in GRAPH_REQUESTS:
        eng.submit(Request(tokens=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=g).numpy(),
                           max_new=m, arrival_s=t))
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "qwen2-moe-a2.7b", "h2o-danube-3-4b",
                                  "gemma2-9b"])
def test_decode_graph_replay_equals_the_eager_forward(cuda, arch):
    eng = _small_engine(arch, cuda)
    sched = eng.scheduler
    assert sched._graph is not None
    replay, steps = sched._decode, []

    def checked():
        cache = {name: t.clone() for name, t in sched._cache.items()}
        tok = torch.from_numpy(sched._tok).to(cuda)
        want, _ = eng.model(tok, mode="decode", cache=cache)
        got = replay()
        assert torch.equal(got, want), f"step {len(steps)}: logits differ"
        assert torch.equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1))
        for name, t in cache.items():
            assert torch.equal(sched._cache[name], t), name
        steps.append(len(steps))
        return got

    sched._decode = checked
    out = eng.drain()
    assert len(steps) >= 8
    assert [out[rid].n_tokens for rid in sorted(out)] == [
        m for _, m, _ in GRAPH_REQUESTS]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "qwen2-moe-a2.7b", "h2o-danube-3-4b",
                                  "gemma2-9b"])
def test_launch_counts_follow_the_graph_replays(cuda, arch):
    from repro_torch import kernels
    eng = _small_engine(arch, cuda)
    plan = eng.cfg.layer_plan()
    attn = sum(s.mixer == "attn" for s in plan)
    mamba = sum(s.mixer == "mamba2" for s in plan)
    ring = sum(s.attn == "window" for s in plan)
    post = 2 * len(plan) if eng.cfg.sandwich_norm else 0   # sandwich norms
    per_step = {"rmsnorm": 2 * len(plan) + 1 + post,
                "rmsnorm.plain": len(plan) + 1 + post,
                "rmsnorm.residual": attn, "rmsnorm.gated": mamba,
                "decode_scores": attn, "decode_stats": attn,
                "decode_scores_ring": ring, "decode_stats_ring": ring}
    assert eng.scheduler._graph.launches == {k: n for k, n in per_step.items()
                                             if n}
    before, st0 = kernels.launch_counts(), eng.stats()
    eng.drain()
    torch.cuda.synchronize()
    after, st = kernels.launch_counts(), eng.stats()
    steps = st["decode_steps"] - st0["decode_steps"]
    prefills = st["prefills"] - st0["prefills"]
    assert steps >= 8 and prefills == len(GRAPH_REQUESTS)
    fwd = {"rmsnorm": 2 * len(plan) + 1 + post,
           "rmsnorm.plain": len(plan) + 1 + post,
           "rmsnorm.residual": attn, "rmsnorm.gated": mamba}
    want = {k: n * (steps + prefills) for k, n in fwd.items()}
    want.update(decode_scores=attn * steps, decode_stats=attn * steps,
                decode_scores_ring=ring * steps,
                decode_stats_ring=ring * steps, flash_attention_d120=0,
                flash_attention=attn * prefills, ssd=mamba * prefills,
                dma_allgather=0, rmsnorm_bwd=0, flash_attention_bwd_dq=0,
                flash_attention_bwd_dkdv=0, flash_attention_bwd_wgmma=0,
                flash_attention_bwd_d120=0, ssd_bwd=0)
    want.update({"rmsnorm_bwd.plain": 0, "rmsnorm_bwd.residual": 0,
                 "rmsnorm_bwd.gated": 0, "rmsnorm.gated_rowsq": 0,
                 "rmsnorm.gated_finish": 0, "rmsnorm_bwd.gated_rowdot": 0,
                 "rmsnorm_bwd.gated_finish": 0})
    assert {k: after[k] - before[k] for k in after} == want


# (q, pl, shard, dtype): every vector width of the copy (16, 8, 4, 2 and 1
# bytes per block), non-power q, and the paper's 64-rank small messages
DMA_CASES = [
    (4, 4, (1000,), torch.bfloat16),     # 2000-byte blocks: 16-byte vectors
    (4, 4, (2, 3), torch.float32),       # 24: 8-byte
    (3, 4, (5,), torch.float32),         # 20: 4-byte, non-power q
    (3, 4, (3,), torch.bfloat16),        # 6: 2-byte, non-power q
    (6, 2, (7,), torch.uint8),           # 7: bytes
    (8, 8, (256,), torch.float32),       # 1 KiB, 64 ranks
    (5, 3, (33, 3), torch.bfloat16),
    # capacity > p: locality_bruck re-sends blocks into spill slots
    (3, 2, (1000,), torch.bfloat16),
    (5, 4, (7,), torch.uint8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm",
                         ["bruck", "ring", "multilane", "locality_bruck"])
@pytest.mark.parametrize("case", DMA_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}-{c[3]}")
def test_dma_allgather_kernel_on_card(cuda, case, algorithm):
    q, pl, shard, dtype = case
    p = q * pl
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(0, 200, (p,) + shard, generator=g, device=cuda,
                      dtype=torch.int32).to(dtype)
    sched = dma_ops.build_schedule(
        algorithm, p, None if algorithm in ("bruck", "ring") else pl)
    before = dma_ops.LAUNCHES
    out = dma_ops.dma_locality_allgather(x, q, pl, algorithm=algorithm)
    torch.cuda.synchronize()
    assert dma_ops.LAUNCHES == before + 1          # every round, one launch
    assert torch.equal(out, dma_ops.dma_allgather_ref(x, sched))
    assert torch.equal(out, x.unsqueeze(0).expand((p,) + x.shape))


@pytest.mark.gpu
def test_dma_allgather_refuses_a_strided_input(cuda):
    sched = dma_ops.build_schedule("locality_bruck", 16, 4)
    x = torch.zeros(8, 32, device=cuda).t()[:16]
    with pytest.raises(ValueError, match="contiguous"):
        dma_ops.dma_allgather(x, sched)


# (Bt, S, H, P, G, N): G in {1, 2}, N in {16, 64, 128}, P in {16, 64}, S
# ragged against the kernel's 64-token chunks and the plain version's Q
SSD_CASES = [
    (1, 512, 48, 64, 1, 128),        # mamba2-780m prefill, Q = 256
    (1, 300, 48, 64, 1, 128),        # one ragged chunk of 300
    (2, 100, 4, 16, 2, 16),
    (1, 130, 6, 64, 2, 64),
    (2, 37, 4, 16, 1, 128),
    (1, 1, 2, 16, 1, 16),            # one token
    (1, 96, 6, 16, 3, 8),            # G = 3, N = 8
]


# (Bt, S, H, P, G, N): the kernel's edges (``checks.EDGE_CASES`` says which)
SSD_EDGE_CASES = list(ssd_checks.EDGE_CASES)


def _ssd_inputs(case, dtype, device):
    Bt, S, H, P, G, N = case
    g = torch.Generator(device=device).manual_seed(4)
    rn = lambda *shape: torch.randn(shape, generator=g, device=device)
    x = rn(Bt, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(Bt, S, H) - 1.0)
    A = -torch.exp(torch.rand((H,), generator=g, device=device) * 2.0)
    B = (rn(Bt, S, G, N) * 0.5).to(dtype)
    C = (rn(Bt, S, G, N) * 0.5).to(dtype)
    return x, dt, A, B, C


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_kernel_on_card(cuda, dtype, case):
    ins = _ssd_inputs(case, dtype, cuda)
    before = ssd_ops.LAUNCHES
    y, h = ssd_ops.ssd(*ins, Q=256)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    assert y.dtype == h.dtype == torch.float32
    ry, rh = ssd_ops.ssd_ref(*ins, Q=256)
    assert float((y - ry).abs().max()) / float(ry.abs().max()) < 1e-4
    assert float((h - rh).abs().max()) / float(rh.abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_EDGE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_kernel_at_the_tile_edges(cuda, dtype, case):
    ins = _ssd_inputs(case, dtype, cuda)
    before = ssd_ops.LAUNCHES
    y, h = ssd_ops.ssd(*ins, Q=256)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    ry, rh = ssd_ops.ssd_ref(*ins, Q=256)
    assert float((y - ry).abs().max()) / float(ry.abs().max()) < 1e-4
    assert float((h - rh).abs().max()) / float(rh.abs().max()) < 1e-4


@pytest.mark.gpu
def test_ssd_kernel_reads_unaligned_bf16_inputs(cuda):
    # x, B and C starting one element past 16 bytes: the scalar load path
    x, dt, A, B, C = _ssd_inputs((1, 90, 4, 16, 1, 64), torch.bfloat16, cuda)
    shift = lambda t: torch.cat([t.flatten()[:1], t.flatten()])[1:].view(
        t.shape)
    xs, Bs, Cs = shift(x), shift(B), shift(C)
    assert xs.data_ptr() % 16 and Bs.data_ptr() % 16 and Cs.data_ptr() % 16
    y, h = ssd_ops.ssd(xs, dt, A, Bs, Cs)
    ry, rh = ssd_ops.ssd_ref(x, dt, A, B, C)
    assert float((y - ry).abs().max()) / float(ry.abs().max()) < 1e-4
    assert float((h - rh).abs().max()) / float(rh.abs().max()) < 1e-4


@pytest.mark.gpu
def test_ssd_refuses_a_strided_input_and_an_unbuilt_head_dim(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 16, 4, 16, 1, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                    B, C)
    with pytest.raises(ValueError, match="head dim"):
        ssd_ops.ssd(x.reshape(1, 16, 8, 8).contiguous(),
                    dt.repeat(1, 1, 2).contiguous(), A.repeat(2), B, C)


@pytest.mark.gpu
def test_ssd_raises_naming_n_and_p_when_the_state_is_too_large(cuda):
    # N = 512 is past the largest state the kernel holds in registers
    # (N = 256)
    x, dt, A, _, _ = _ssd_inputs((1, 16, 4, 16, 1, 16), torch.float32, cuda)
    big = torch.zeros((1, 16, 1, 512), device=cuda)
    with pytest.raises(RuntimeError, match="N=512, P=16"):
        ssd_ops.ssd(x, dt, A, big, big)
    # the refused opt-in leaves no error behind for the next launch
    y, _ = ssd_ops.ssd(x, dt, A, big[..., :16].contiguous(),
                       big[..., :16].contiguous())
    torch.cuda.synchronize()
    assert y.shape == x.shape


# ---------------------------------------------------------------------------
# the training path's backward kernels (and the forward's lse output)
# ---------------------------------------------------------------------------
# fp32 gradients 1e-4 (another summation order over up to S terms); bf16
# gradients, rounded once from fp32 sums, against the plain backward in
# fp32 on the same bf16 inputs at atol 1e-3 plus rtol 1e-2: mostly
# relative, since most gradients of randn inputs at D = 128 are 0.03-0.1
BWD_BF16_VS_FP32 = dict(atol=1e-3, rtol=1e-2)
# every forward case (the softcapped ones and D = 120 among them), and:
BWD_CASES = FLASH_CASES + [
    (2, 256, 256, 24, 8, 128, dict(causal=True)),
    (1, 200, 200, 8, 2, 256, dict(causal=True, window=70)),
    # the tensor-core pair's 64-row tiles (queries in dq, keys in dk/dv):
    # S and T at their edges and apart, G = 1, 3 and 8, D = 32, 64 and 128,
    # B = 1 and 4, every mask, and one rank's shape of the FSDP training
    (1, 1, 1, 8, 1, 32, dict(causal=True)),             # G = 8, one token
    (4, 128, 128, 8, 1, 32, dict(causal=True)),         # B = 4, G = 8
    (1, 63, 1, 4, 4, 64, dict(causal=False)),           # T = 1
    (2, 64, 63, 24, 8, 32, dict(causal=True)),          # S != T, causal
    (1, 129, 65, 6, 2, 32, dict(causal=False)),         # S != T
    (1, 65, 129, 3, 1, 64, dict(causal=False)),         # S != T, G = 3
    (4, 127, 127, 24, 8, 128, dict(causal=True, window=64)),
    (1, 128, 128, 3, 1, 128, dict(causal=True, window=1)),
    (2, 129, 129, 8, 1, 64, dict(causal=True, chunk=64)),
    (1, 200, 200, 6, 2, 64, dict(causal=False, window=50)),
    (1, 1024, 1024, 24, 8, 128, dict(causal=True)),     # an FSDP rank's
    # enough (kv head, key tile) blocks that dk/dv takes a kv head's G q
    # heads in one block (the cases above split them over a cluster)
    (4, 640, 640, 16, 8, 64, dict(causal=True)),
    # the softcap on the tensor cores at D = 32, 64 and 128 (G = 4, 3, 3;
    # a window with it, a cluster split and one block a kv head)
    (2, 130, 130, 8, 2, 32, dict(causal=True, cap=50.0)),
    (1, 200, 200, 6, 2, 64, dict(causal=True, window=64, cap=30.0)),
    (1, 257, 257, 24, 8, 128, dict(causal=True, cap=50.0)),
    (4, 640, 640, 16, 8, 64, dict(causal=True, cap=50.0)),
    # head dim 120 at the 64-row tiles' edges (S = 63, 64, 65, 129), S != T,
    # a window that bites, G = 4 and 1, and with a cap
    (1, 63, 63, 32, 8, 120, dict(causal=True)),
    (1, 64, 64, 8, 8, 120, dict(causal=True)),
    (2, 65, 65, 32, 8, 120, dict(causal=True, window=64)),
    (1, 129, 129, 8, 2, 120, dict(causal=True, window=50, cap=50.0)),
    (1, 65, 129, 4, 1, 120, dict(causal=False)),
    (2, 1024, 1024, 32, 8, 120, dict(causal=True, window=4096)),
    # head dim 256 (gemma2-9b) on the tensor cores, two warpgroups a block
    # splitting the head dim: S = 1, 63, 64, 65 and 129 and S != T, G = 1,
    # 2 and 8, B = 1 (dk/dv splits G over a cluster of 2, 4 or 8) and
    # B = 4 (one block a kv head), every mask, caps 50 and 30
    (1, 1, 1, 16, 8, 256, dict(causal=True)),           # one token, G = 2
    (1, 63, 63, 8, 8, 256, dict(causal=True)),          # G = 1
    (1, 64, 64, 8, 1, 256, dict(causal=True, cap=50.0)),    # G = 8
    (2, 65, 65, 16, 8, 256, dict(causal=True, window=32)),
    (1, 129, 129, 16, 8, 256, dict(causal=True, chunk=64, cap=30.0)),
    (1, 65, 129, 4, 2, 256, dict(causal=False)),        # S != T
    (1, 129, 65, 8, 1, 256, dict(causal=False, cap=50.0)),
    (4, 300, 300, 16, 8, 256, dict(causal=True, cap=50.0)),
    (1, 1024, 1024, 16, 8, 256, dict(causal=True, cap=50.0)),
]


def _flash_inputs(case, dtype, device, seed=0):
    B, S, T, H, KV, D, mask = case
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=device).to(dtype)
    return rnd(B, S, H, D), rnd(B, T, KV, D), rnd(B, T, KV, D), \
        rnd(B, S, H, D), mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_lse_on_card(cuda, dtype, case):
    """The forward writing lse: o bitwise the serving forward's, lse the
    plain version's (1e-4 fp32, 2e-3 bf16: fp32 sums of bf16 inputs)."""
    q, k, v, _, mask = _flash_inputs(case, dtype, cuda)
    o, lse = flash_ops.flash_attention_lse(q, k, v, **mask)
    assert torch.equal(o, flash_ops.flash_attention(q, k, v, **mask))
    ref = flash_ops.attention_lse_ref(q, k, v, **mask)[1]
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(lse, ref, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernel_on_card(cuda, dtype, case):
    """dq, dk, dv against the plain backward on the same (o, lse), bf16
    also against it in fp32, two calls bitwise equal, one launch of each
    kernel a call: the tensor-core pair for bf16 (at D = 256 its
    two-warpgroup form), the CUDA-core pair for fp32."""
    q, k, v, do, mask = _flash_inputs(case, dtype, cuda)
    o, lse = flash_ops.flash_attention_lse(q, k, v, **mask)
    n = (flash_ops.BWD_DQ_LAUNCHES, flash_ops.BWD_DKDV_LAUNCHES,
         flash_ops.BWD_WGMMA_LAUNCHES, flash_ops.BWD_D120_LAUNCHES)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    tensor_cores = flash_ops.bwd_on_tensor_cores(dtype, case[5])
    assert (flash_ops.BWD_DQ_LAUNCHES - n[0],
            flash_ops.BWD_DKDV_LAUNCHES - n[1],
            flash_ops.BWD_WGMMA_LAUNCHES - n[2],
            flash_ops.BWD_D120_LAUNCHES - n[3]) == (
                1, 1, 2 * tensor_cores, 2 * (case[5] == 120))
    ref = flash_ops.attention_bwd_ref(q, k, v, o, do, lse, **mask)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, dtype, 1e-4)
    if dtype == torch.bfloat16:
        ref32 = flash_ops.attention_bwd_ref(
            *(t.float() for t in (q, k, v, o, do)), lse, **mask)
        for a, b in zip(got, ref32):
            torch.testing.assert_close(a.float(), b, **BWD_BF16_VS_FP32)
    again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_train_gradients_match_autograd_of_the_plain_version(cuda,
                                                                   dtype):
    """``flash_attention_train`` end to end against torch.autograd of
    ``attention_ref`` at the llama3.2-3b heads (fp32 1e-4, bf16 2e-2)."""
    q, k, v, do, mask = _flash_inputs((2, 200, 200, 24, 8, 128,
                                       dict(causal=True)), dtype, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_ops.flash_attention_train(*leaves, **mask)
    got = torch.autograd.grad(out, leaves, do)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ops.attention_ref(*refs, **mask), refs,
                               do)
    for a, b in zip(got, want):
        _close(a, b, dtype, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 200, 200, 32, 8, 120, dict(causal=True, window=64)),    # h2o-danube
    (1, 150, 150, 16, 8, 256, dict(causal=True, window=64, cap=50.0))])
def test_flash_train_gradients_of_the_variants(cuda, dtype, case):
    """``flash_attention_train`` at the dense variants' heads, a window
    that bites and gemma2's cap, against torch.autograd of
    ``attention_ref`` (fp32 1e-4, bf16 2e-2)."""
    q, k, v, do, mask = _flash_inputs(case, dtype, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_ops.flash_attention_train(*leaves, **mask),
                              leaves, do)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ops.attention_ref(*refs, **mask), refs,
                               do)
    for a, b in zip(got, want):
        _close(a, b, dtype, 1e-4)


# a model rank's heads of the dense variants on a tier of 2 (B = 1 x 1,024):
# gemma2-9b's 8/4 heads of 256 with and without cap 50, h2o-danube-3-4b's
# 16/4 of 120 with its 4,096 window
TIER_VARIANT_CASES = [
    (1, 1024, 1024, 8, 4, 256, dict(causal=True, cap=50.0)),
    (1, 1024, 1024, 8, 4, 256, dict(causal=True)),
    (1, 1024, 1024, 16, 4, 120, dict(causal=True, window=4096))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TIER_VARIANT_CASES, ids=str)
def test_flash_pair_at_a_model_ranks_variant_heads(cuda, dtype, case):
    """The forward with lse and the backward pair at a model rank's heads:
    o and lse against the plain forward (o 1e-4 fp32, 2e-2 bf16; lse 1e-4,
    2e-3), dq, dk, dv against the plain backward on the same (o, lse), bf16
    also against it in fp32, one launch of each backward kernel, on the
    tensor cores for bf16."""
    q, k, v, do, mask = _flash_inputs(case, dtype, cuda)
    o, lse = flash_ops.flash_attention_lse(q, k, v, **mask)
    ref_o, ref_lse = flash_ops.attention_lse_ref(q, k, v, **mask)
    fp32 = dtype == torch.float32
    _close(o, ref_o, dtype, 1e-4)
    tol = 1e-4 if fp32 else 2e-3
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    n = (flash_ops.BWD_DQ_LAUNCHES, flash_ops.BWD_DKDV_LAUNCHES,
         flash_ops.BWD_WGMMA_LAUNCHES)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    assert (flash_ops.BWD_DQ_LAUNCHES - n[0],
            flash_ops.BWD_DKDV_LAUNCHES - n[1],
            flash_ops.BWD_WGMMA_LAUNCHES - n[2]) == (1, 1, 2 * (not fp32))
    ref = flash_ops.attention_bwd_ref(q, k, v, o, do, lse, **mask)
    for a, b in zip(got, ref):
        _close(a, b, dtype, 1e-4)
    if not fp32:
        ref32 = flash_ops.attention_bwd_ref(
            *(t.float() for t in (q, k, v, o, do)), lse, **mask)
        for a, b in zip(got, ref32):
            torch.testing.assert_close(a.float(), b, **BWD_BF16_VS_FP32)


# the training shapes (one rank: 4,096 rows; an FSDP rank: 1,024), a
# phase-7-sized 135 rows, narrow and wide rows, and d % 4 != 0 (one value
# an access)
RMS_BWD_CASES = [(4096, 3072), (37, 100), (8, 3072), (3, 5, 128),
                 (1000, 8192), (1024, 3072), (135, 3072), (5, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", RMS_BWD_CASES, ids=str)
def test_rmsnorm_bwd_kernel_on_card(cuda, dtype, residual, shape):
    """dx and dscale against the plain backward (fp32 dx 1e-5, dscale, a
    sum over every row, 1e-4 relative; bf16 2e-2), bitwise equal across two
    calls, one launch a call (the rows and the dscale sums)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    x, dy = (rnd(*shape) * 2).to(dtype), rnd(*shape).to(dtype)
    sc = (rnd(shape[-1]) * 0.2).to(dtype)
    ds = rnd(*shape).to(dtype) if residual else None
    form = "residual" if residual else "plain"
    n = (rms_ops.BWD_LAUNCHES, rms_ops.FORM_BWD_LAUNCHES[form])
    dx, dsc = rms_ops.rmsnorm_bwd(x, sc, dy, ds=ds)
    assert (rms_ops.BWD_LAUNCHES - n[0],
            rms_ops.FORM_BWD_LAUNCHES[form] - n[1]) == (1, 1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    assert not rms_ops.bwd_counters(x.device, stream).any()   # set back
    rdx, rdsc = rms_ops.rmsnorm_bwd_ref(x, sc, dy, ds=ds)
    assert dx.dtype == rdx.dtype and dsc.dtype == rdsc.dtype
    _close(dx, rdx, dtype, 1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(dsc, rdsc, atol=1e-4, rtol=1e-4)
    else:
        _close(dsc, rdsc, dtype, None)
    dx2, dsc2 = rms_ops.rmsnorm_bwd(x, sc, dy, ds=ds)
    assert torch.equal(dx, dx2) and torch.equal(dsc, dsc2)


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_bwd_on_two_streams(cuda, residual):
    """Backwards on two streams of one card at once, each stream with its
    own counters: every dx and dscale against the plain backward (fp32),
    and both streams' counters zero afterwards."""
    g = torch.Generator(device=cuda).manual_seed(2)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    rows, d = 4096, 3072
    sets = [(rnd(rows, d) * 2, rnd(d) * 0.2, rnd(rows, d),
             rnd(rows, d) if residual else None) for _ in range(2)]
    streams = [torch.cuda.Stream(cuda) for _ in sets]
    torch.cuda.synchronize(cuda)
    outs = [[], []]
    for _ in range(4):                  # launches of the two interleaved
        for i, (s, (x, sc, dy, ds)) in enumerate(zip(streams, sets)):
            with torch.cuda.stream(s):
                outs[i].append(rms_ops.rmsnorm_bwd(x, sc, dy, ds=ds))
    torch.cuda.synchronize(cuda)
    for s, (x, sc, dy, ds), got in zip(streams, sets, outs):
        rdx, rdsc = rms_ops.rmsnorm_bwd_ref(x, sc, dy, ds=ds)
        for dx, dsc in got:
            _close(dx, rdx, torch.float32, 1e-5)
            torch.testing.assert_close(dsc, rdsc, atol=1e-4, rtol=1e-4)
        assert not rms_ops.bwd_counters(x.device, s.cuda_stream).any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_train_gradients_match_autograd_of_the_plain_version(cuda,
                                                                     dtype):
    """Both autograd Functions end to end against torch.autograd of the
    plain forms (fp32 1e-5 dx, 1e-4 dscale; bf16 2e-2)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    x, delta = (rnd(64, 3072) * 2).to(dtype), rnd(64, 3072).to(dtype)
    sc = (rnd(3072) * 0.2).to(dtype)
    w1, w2 = rnd(64, 3072).to(dtype), rnd(64, 3072).to(dtype)

    def run(norm, fused):
        leaves = [t.clone().requires_grad_() for t in (x, delta, sc)]
        s, y = fused(*leaves)
        loss = (norm(s, leaves[2]).float() * w1.float()).sum() \
            + (y.float() * w2.float()).sum() + s.float().sum()
        return torch.autograd.grad(loss, leaves)

    got = run(rms_ops.rmsnorm_train, rms_ops.rmsnorm_residual_train)
    want = run(rms_ops.rmsnorm_ref, rms_ops.rmsnorm_residual_ref)
    for a, b, fp32_tol in zip(got, want, (1e-4, 1e-4, 1e-3)):
        tol = fp32_tol if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the SSD scan's backward and the gated RMSNorm's backward
# ---------------------------------------------------------------------------
# the forward's edge cases and the backward's own shapes, and the limits
# (max |err| / max |ref| per gradient against the plain backward in fp32 on
# the same inputs), as ``checks`` states them: chip_smoke.py and the CPU
# emulation of the split read the same
SSD_BWD_CASES = list(ssd_checks.BWD_CASES)
SSD_BWD_REL = ssd_checks.BWD_REL


def _ssd_bwd_errors(got, ins, dy) -> dict:
    up = [t.float() if t.dtype == torch.bfloat16 else t for t in ins]
    want = ssd_ops.ssd_bwd_ref(*up, dy, Q=256)
    # a gradient that is exactly 0 (dA of a one-token sequence: the state
    # before it is 0) is held to 0
    return {n: float((a.float() - b).abs().max())
            / max(float(b.abs().max()), 1e-30)
            for n, a, b in zip(SSD_BWD_REL, got, want)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_bwd_kernel_on_card(cuda, dtype, case):
    """dx, ddt, dA, dB and dC against the plain backward (fp32 on the same
    inputs), each in its input's dtype; two calls bitwise equal; the
    backward's launches counted a call."""
    ins = _ssd_inputs(case, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn(ins[0].shape, generator=g, device=cuda)
    before = ssd_ops.BWD_LAUNCHES
    got = ssd_ops.ssd_bwd(*ins, dy)
    torch.cuda.synchronize()
    assert ssd_ops.BWD_LAUNCHES == before + ssd_ops.BWD_KERNELS
    assert [t.dtype for t in got] == [ins[0].dtype, torch.float32,
                                      torch.float32, ins[3].dtype,
                                      ins[4].dtype]
    for name, err in _ssd_bwd_errors(got, ins, dy).items():
        tol = ssd_checks.bwd_limit(name, dtype == torch.bfloat16)
        assert err < tol, (name, err)
    again = ssd_ops.ssd_bwd(*ins, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_ssd_bwd_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 16, 4, 16, 1, 16), torch.float32, cuda)
    big = torch.zeros((1, 16, 1, 512), device=cuda)
    with pytest.raises(ValueError, match="N=512"):
        ssd_ops.ssd_bwd(x, dt, A, big, big, torch.zeros_like(x))
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_bwd(x, dt, A, B, C, torch.zeros_like(x).double())
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_bwd(x, dt, A, B, C, torch.zeros((1, 16, 4, 8), device=cuda))
    with pytest.raises(ValueError, match="head dim"):
        ssd_ops.ssd_bwd(x.reshape(1, 16, 8, 8).contiguous(),
                        dt.repeat(1, 1, 2).contiguous(), A.repeat(2), B, C,
                        torch.zeros((1, 16, 8, 8), device=cuda))


@pytest.mark.gpu
def test_ssd_train_gradients_match_autograd_of_the_plain_version(cuda):
    """``ssd_train`` through torch.autograd (the forward kernel, then the
    backward kernels) against autograd through ``ssd_ref``, fp32, at the
    tolerances above; one forward launch and one backward call (its
    ``BWD_KERNELS`` launches)."""
    ins = _ssd_inputs((2, 200, 8, 32, 2, 64), torch.float32, cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    w = torch.randn(ins[0].shape, generator=g, device=cuda)
    counts = (ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        y, h = fn(*leaves, Q=256)
        assert h.requires_grad == (fn is ssd_ops.ssd_ref)
        return torch.autograd.grad((y * w).sum(), leaves)

    got = run(ssd_ops.ssd_train)
    assert (ssd_ops.LAUNCHES - counts[0], ssd_ops.BWD_LAUNCHES - counts[1]) \
        == (1, ssd_ops.BWD_KERNELS)
    want = run(ssd_ops.ssd_ref)
    for name, a, b in zip(SSD_BWD_REL, got, want):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err < SSD_BWD_REL[name], (name, err)


# (rows, d, width of the tensor z is a column slice of, z's first column):
# the mamba2-780m training rows (z the first 3,072 columns of in_proj's
# 6,448), ragged rows, d % 4 != 0 and an odd offset (one value an access)
RMS_GATED_BWD_CASES = [(4096, 3072, 6448, 0), (37, 40, 40, 0),
                       (256, 256, 600, 8), (5, 37, 90, 3), (64, 1536, 1600, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RMS_GATED_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_rmsnorm_gated_bwd_kernel_on_card(cuda, dtype, case):
    """dy (fp32) and dz against the plain backward (dy 1e-5 in both dtypes:
    fp32 from the same rounded inputs; fp32 dz 1e-5 and dscale, a sum over
    every row, 1e-4; bf16 dz and dscale 2e-2), bitwise equal across two
    calls, one launch a call, the counters set back."""
    rows, d, width, off = case
    g = torch.Generator(device=cuda).manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    y = rnd(rows, d) * 2
    z = (rnd(rows, width) * 2).to(dtype)[:, off:off + d]
    sc = (rnd(d) * 0.2).to(dtype)
    dout = rnd(rows, d).to(dtype)
    n = (rms_ops.BWD_LAUNCHES, rms_ops.FORM_BWD_LAUNCHES["gated"])
    dy, dz, dsc = rms_ops.rmsnorm_gated_bwd(y, z, sc, dout)
    assert (rms_ops.BWD_LAUNCHES - n[0],
            rms_ops.FORM_BWD_LAUNCHES["gated"] - n[1]) == (1, 1)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    assert not rms_ops.bwd_counters(y.device, stream).any()
    rdy, rdz, rdsc = rms_ops.rmsnorm_gated_bwd_ref(y, z, sc, dout)
    assert (dy.dtype, dz.dtype, dsc.dtype) == (rdy.dtype, rdz.dtype,
                                                rdsc.dtype)
    assert dy.is_contiguous() and dz.is_contiguous()
    _close(dy, rdy, torch.float32, 1e-5)
    _close(dz, rdz, dtype, 1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(dsc, rdsc, atol=1e-4, rtol=1e-4)
    else:
        _close(dsc, rdsc, dtype, None)
    again = rms_ops.rmsnorm_gated_bwd(y, z, sc, dout)
    assert all(torch.equal(a, b) for a, b in zip((dy, dz, dsc), again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gated_train_gradients_match_autograd_of_the_plain_version(
        cuda, dtype):
    """``rmsnorm_gated_train`` on a slice of a wider tensor, through
    torch.autograd, against autograd of the plain form (fp32 1e-4, bf16
    5e-2: autograd rounds the bf16 product's gradients where the kernel
    keeps fp32)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    y, proj = rnd(64, 3072) * 2, (rnd(64, 6448) * 2).to(dtype)
    sc = (rnd(3072) * 0.2).to(dtype)
    w = rnd(64, 3072).to(dtype)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (y, proj, sc)]
        out = fn(leaves[0], leaves[1][:, :3072], leaves[2], eps=1e-5)
        return torch.autograd.grad((out.float() * w.float()).sum(), leaves)

    got = run(rms_ops.rmsnorm_gated_train)
    want = run(rms_ops.rmsnorm_gated_ref)
    for a, b, fp32_tol in zip(got, want, (1e-4, 1e-4, 1e-3)):
        tol = fp32_tol if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


# the gated form split over a model tier, one rank's columns of every row:
# (rows, columns a rank, m, width of the tensor z is a column slice of):
# 8f's rank of mamba2-780m at m = 2 and 4 (z a slice of the rank's in_proj
# output), ragged rows, and d % 4 != 0 (one value an access)
RMS_GATED_TIER_CASES = [(1024, 1536, 2, 3352), (1024, 768, 4, 1804),
                        (37, 40, 2, 90), (5, 37, 3, 80)]


class _SumTier:
    """A model tier of one rank: its sum is the value itself."""

    @staticmethod
    def all_reduce(x):
        return x


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RMS_GATED_TIER_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_rmsnorm_gated_tier_kernels_on_card(cuda, dtype, case):
    """The split gated forms over m ranks' columns, the tier's sums
    emulated by summing every rank's first launch: the rows' sums of
    squares and dot products against their plain versions (1e-5 and 1e-4
    relative), the finishes against the unsplit plain forward and
    backward on the whole rows, this rank's columns (the unsplit cases'
    limits: out and dz 1e-5 fp32 and 2e-2 bf16, dy 1e-5, dscale 1e-4 fp32
    and 2e-2 bf16), one launch each, the backward finish bitwise equal
    across two calls and its counters set back."""
    rows, d, m, width = case
    g = torch.Generator(device=cuda).manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    ys = [rnd(rows, d) * 2 for _ in range(m)]
    zs = [(rnd(rows, width) * 2).to(dtype)[:, :d] for _ in range(m)]
    scs = [(rnd(d) * 0.2).to(dtype) for _ in range(m)]
    douts = [rnd(rows, d).to(dtype) for _ in range(m)]
    full = [torch.cat(t, -1).contiguous() for t in (ys, zs, scs, douts)]
    y, z, sc, dout = ys[0], zs[0], scs[0], douts[0]
    n = dict(rms_ops.FORM_LAUNCHES), dict(rms_ops.FORM_BWD_LAUNCHES)
    ss = torch.stack([rms_ops.rmsnorm_gated_rowsq(a, b)
                      for a, b in zip(ys, zs)]).sum(0)
    torch.testing.assert_close(rms_ops.rmsnorm_gated_rowsq(y, z),
                               rms_ops.rmsnorm_gated_rowsq_ref(y, z),
                               atol=0, rtol=1e-5)
    out = rms_ops.rmsnorm_gated_finish(y, z, sc, ss, d_norm=m * d)
    assert out.dtype == dtype and out.shape == (rows, d)
    _close(out, rms_ops.rmsnorm_gated_ref(*full[:3])[:, :d], dtype, 1e-5)
    dot = torch.stack([rms_ops.rmsnorm_gated_rowdot(*a) for a in
                       zip(ys, zs, scs, douts)]).sum(0)
    torch.testing.assert_close(
        rms_ops.rmsnorm_gated_rowdot(y, z, sc, dout),
        rms_ops.rmsnorm_gated_rowdot_ref(y, z, sc, dout), atol=1e-4,
        rtol=1e-4)
    got = rms_ops.rmsnorm_gated_bwd(y, z, sc, dout, row_ss=ss, row_dot=dot,
                                    d_norm=m * d)
    assert (rms_ops.FORM_LAUNCHES["gated_rowsq"] - n[0]["gated_rowsq"],
            rms_ops.FORM_LAUNCHES["gated_finish"] - n[0]["gated_finish"],
            rms_ops.FORM_BWD_LAUNCHES["gated_rowdot"]
            - n[1]["gated_rowdot"],
            rms_ops.FORM_BWD_LAUNCHES["gated_finish"]
            - n[1]["gated_finish"]) == (m + 1, 1, m + 1, 1)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    assert not rms_ops.bwd_counters(y.device, stream).any()
    rdy, rdz, rdsc = rms_ops.rmsnorm_gated_bwd_ref(*full)
    _close(got[0], rdy[:, :d], torch.float32, 1e-5)
    _close(got[1], rdz[:, :d], dtype, 1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(got[2], rdsc[:d], atol=1e-4, rtol=1e-4)
    else:
        _close(got[2], rdsc[:d], dtype, None)
    again = rms_ops.rmsnorm_gated_bwd(y, z, sc, dout, row_ss=ss, row_dot=dot,
                                      d_norm=m * d)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gated_tier_train_on_one_rank_is_the_gated_form(cuda,
                                                                dtype):
    """``rmsnorm_gated_tier_train`` on a tier of one rank (its sums the
    values themselves) through torch.autograd, against
    ``rmsnorm_gated_train``: the same function, so the outputs and
    gradients agree within fp32 1e-5 and bf16 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(4)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    y, proj = rnd(64, 1536) * 2, (rnd(64, 3352) * 2).to(dtype)
    sc = (rnd(1536) * 0.2).to(dtype)
    w = rnd(64, 1536).to(dtype)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (y, proj, sc)]
        out = fn(leaves[0], leaves[1][:, :1536], leaves[2])
        return (out,) + torch.autograd.grad(
            (out.float() * w.float()).sum(), leaves)

    got = run(lambda a, b, c: rms_ops.rmsnorm_gated_tier_train(
        a, b, c, _SumTier(), d_norm=1536))
    want = run(rms_ops.rmsnorm_gated_train)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
