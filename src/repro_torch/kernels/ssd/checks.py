"""The shapes and limits at which the SSD kernels are held against their
plain versions. The card tests (``tests/test_torch_cuda.py``),
``chip_smoke.py``'s phase 2c and the CPU emulation of the backward's split
products (``tests/test_torch_ssd_bwd_split.py``) read them here.

A shape is (Bt, S, H, P, G, N)."""

# The kernels' edges. One token; S a multiple of the 64-token chunk and one
# past it; P of 1 to 4 tiles of 16; G = 2 and 3; N = 8 (padded to 16), 24
# (padded to 32), 12 (not a multiple of 8: the scalar load path for bf16
# too), 64, 128 and 256, the largest state the kernels take.
EDGE_CASES = (
    (1, 1, 4, 64, 1, 128),
    (1, 64, 4, 64, 1, 128),
    (1, 65, 4, 64, 1, 128),
    (1, 129, 3, 48, 3, 64),
    (2, 200, 4, 32, 2, 8),
    (1, 77, 6, 16, 3, 24),
    (1, 70, 2, 16, 1, 12),
    (1, 150, 4, 64, 2, 256),
    (1, 100, 4, 32, 1, 128),
)

# The backward's: the edges, the mamba2-780m training shape at one
# sequence, the mamba2 widths at a ragged S (all 48 heads in one group: the
# longest sum over heads), and P = 80 (a partial tile of 64 columns).
BWD_CASES = EDGE_CASES + ((1, 1024, 48, 64, 1, 128),
                          (2, 1000, 48, 64, 1, 128),
                          (2, 300, 8, 80, 1, 16))

# The backward against the plain one in fp32 on the same inputs, max |err| /
# max |ref| per gradient: fp32 1e-4 (the forward's); dA, a sum of terms of
# both signs over every token, 1e-3 (it cancels: the same roundings are a
# larger share of it). In bf16, dx, dB and dC are within BWD_BF16_REL: one
# rounding of the fp32 value (2^-9 of it).
BWD_REL = {"dx": 1e-4, "ddt": 1e-4, "dA": 1e-3, "dB": 1e-4, "dC": 1e-4}
BWD_BF16_REL = 1e-2


def bwd_limit(name: str, bf16: bool) -> float:
    """The limit of gradient ``name`` (a key of ``BWD_REL``)."""
    return BWD_BF16_REL if bf16 and name in ("dx", "dB", "dC") \
        else BWD_REL[name]
