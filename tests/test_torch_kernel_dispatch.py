"""The launch choices of the FedAvg reduce (K1) and Hellinger strip (K2)
kernels, which their wrappers make in Python and pass to the kernels: K1's
columns a thread (the width of its loads), K2's store path and tile rows a
thread.  Table-driven over the port's path shapes and the misaligned
cases; the kernels themselves run only on the card
(``tests/test_torch_gpu.py``)."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.aggregate.ops import load_width  # noqa: E402
from repro_torch.kernels.hellinger.ops import tile_choice  # noqa: E402

BASE = 0x7F00_0000_0000  # a caching-allocator address: 512-byte aligned
H100_SMS = 132


@pytest.mark.parametrize("case,addr,n,elt,want", [
    # the path shapes: rows 8-byte aligned (796,840 B) -> 8-byte loads
    ("classification fp32", BASE, 199_210, 4, 2),
    # rows 16-byte aligned -> 16-byte loads
    ("stablelm-3b fp32", BASE, 380_789_760, 4, 4),
    ("hymba-1.5b fp32", BASE, 344_430_400, 4, 4),
    # rows only 4-byte aligned (398,420 B) -> 2 x bf16
    ("bf16 (64, 199,210)", BASE, 199_210, 2, 2),
    ("bf16 rows 16-byte aligned", BASE, 600_000, 2, 8),
    # 16-byte loads would leave 195 blocks, under two an SM: 8-byte loads
    ("grid cap", BASE, 199_212, 4, 2),
    # a base 8- or 4-byte aligned: rows 1.. of a contiguous (m + 1, n) tensor
    ("fp32 base + 8", BASE + 4 * 600_002, 600_002, 4, 2),
    ("fp32 base + 4", BASE + 4 * 600_001, 600_001, 4, 1),
    ("bf16 base + 4", BASE + 2 * 600_002, 600_002, 2, 2),
    ("bf16 odd n", BASE, 600_001, 2, 1),
    # n % 8 = 3 and 4 in fp32
    ("fp32 n = 3 mod 8", BASE, 600_003, 4, 1),
    ("fp32 n = 4 mod 8", BASE, 600_004, 4, 4),
    # too small for two blocks an SM at any width: one column a thread
    ("tiny", BASE, 5, 4, 1),
    ("tiny bf16", BASE, 4099, 2, 1),
])
def test_reduce_launch_shape(case, addr, n, elt, want):
    vec = load_width(addr, n, elt, H100_SMS)
    assert vec == want, case
    # the kernel's contract: aligned vectors in every row, no tail
    assert n % vec == 0 and addr % (vec * elt) == 0 and (n * elt) % (vec * elt) == 0
    # a vector width only where the grid of 256-thread blocks keeps two an SM
    assert vec == 1 or -(-n // vec // 256) >= 2 * H100_SMS


def test_reduce_launch_shape_follows_the_sm_count():
    # fewer SMs need fewer blocks, so a wider load fits
    assert load_width(BASE, 199_212, 4, H100_SMS) == 2
    assert load_width(BASE, 199_212, 4, 64) == 4


@pytest.mark.parametrize("case,b,k,addr,want", [
    # the setup strips: two 64 x 128 tiles, so 32 x 128 ones
    ("classification (100, 100)", 100, 100, BASE, (True, 4)),
    ("population strip (4096, 16384)", 4096, 16_384, BASE, (True, 8)),
    ("blocked, block = 7, K = 300", 7, 300, BASE, (True, 4)),
    ("r[7:300] against r", 293, 300, BASE, (True, 4)),
    ("k % 4 = 1", 70, 301, BASE, (False, 4)),
    ("k % 4 = 2", 129, 302, BASE, (False, 4)),
    ("k % 4 = 3", 65, 303, BASE, (False, 4)),
    ("out not 16-byte aligned", 64, 128, BASE + 4, (False, 4)),
    ("one output", 1, 1, BASE, (False, 4)),
    # 2 x 66 = 132 tiles of 64 x 128 give each SM one; 2 x 65 do not
    ("one tile an SM", 128, 66 * 128, BASE, (True, 8)),
    ("just under one tile an SM", 128, 65 * 128, BASE, (True, 4)),
    ("1000 x 1000: 128 tiles", 1000, 1000, BASE, (True, 4)),
    ("2000 x 2000: 512 tiles", 2000, 2000, BASE, (True, 8)),
    ("large, k % 4 = 1", 4096, 16_385, BASE, (False, 8)),
])
def test_strip_launch_shape(case, b, k, addr, want):
    assert tile_choice(b, k, addr, H100_SMS) == want, case


def test_strip_launch_shape_follows_the_sm_count():
    # fewer SMs are filled by fewer tiles, so the larger tile pays
    assert tile_choice(128, 65 * 128, BASE, H100_SMS) == (True, 4)
    assert tile_choice(128, 65 * 128, BASE, 64) == (True, 8)
