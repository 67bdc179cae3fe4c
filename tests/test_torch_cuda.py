"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where no CUDA device is visible and run with
``python -m pytest -m gpu tests/test_torch_cuda.py`` on a machine with an
H100 and ``nvcc`` (the kernels build at first use). This file imports no
JAX, so it runs where only PyTorch is installed. Tolerances: fp32 rmsnorm
1e-5 in all three forms (the residual sum itself equal to the eager add),
fp32 attention and decode stats 1e-4 (the kernels sum in another
order); bf16 outputs 2e-2 (one bf16 ulp at 4 is 1.6e-2); the DMA allgather
copies bytes and is held equal; the SSD scan (fp32 output whatever its
input dtype, held against the plain version on the same inputs) max |y -
y_ref| / max |y_ref| < 1e-4 and max |h - h_ref| / max |h_ref| < 1e-4, the chunk
invariance bound of ``tests/test_kernels.py`` (the kernel chunks by 64,
the plain version by Q).
"""
import pytest
import torch

from repro_torch.kernels.decode_stats import ops as stats_ops
from repro_torch.kernels.dma_allgather import ops as dma_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
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
@pytest.mark.parametrize("shape", [(8, 3072), (37, 100), (2, 5, 128)])
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
                  (5, 37, 0), (4, 256, 1)]


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
    before = flash_ops.LAUNCHES
    out = flash_ops.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
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


# (Bt, S, H, P, G, N): the kernel's edges. One token; S a multiple of the
# 64-token chunk and one past it; P of 1 to 4 tiles of 16; G = 2 and 3;
# N = 8 (padded to 16), 24 (padded to 32), 12 (not a multiple of 8: the
# scalar load path for bf16 too), 64, 128 and 256, the largest state the
# kernel takes
SSD_EDGE_CASES = [
    (1, 1, 4, 64, 1, 128),
    (1, 64, 4, 64, 1, 128),
    (1, 65, 4, 64, 1, 128),
    (1, 129, 3, 48, 3, 64),
    (2, 200, 4, 32, 2, 8),
    (1, 77, 6, 16, 3, 24),
    (1, 70, 2, 16, 1, 12),
    (1, 150, 4, 64, 2, 256),
    (1, 100, 4, 32, 1, 128),
]


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
