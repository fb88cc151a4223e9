"""The algorithm of the port's int8 distance kernel
(``csrc/quant_distance.cu``), mirrored in plain PyTorch and held against
the JAX package on the CPU.

``quant_scores_mirror`` runs the kernel's arithmetic: the scale folded
into the query (``u = q * scale``), each query's ``u`` scaled by one
power of two (``v = u 2^-E``, ``|v| < 1``) and cut into three fixed-point
bf16 pieces (grids 2^-8, 2^-16, 2^-24), the int8 codes as bf16 values, d
padded to a multiple of 16 with zero codes and zero pieces and cut into
slices of 128 columns, the queries padded to blocks of 128 and the rows
to tiles of 64, the ragged tiles masked on the way out. Each slice has
two accumulators that start from zero: the first piece's, chained over
the k-steps (16 columns) and exact in float32 (the mirror asserts it),
and the two smaller pieces', v3 then v2 each k-step. The tensor cores'
accumulation is modelled as the card does it: each instruction's sum of
16 exact products and the accumulator, rounded toward zero to float32.
The slices meet in float32 in order. ``|q|^2``, ``q.z`` and ``|x|^2``
(from the rows rounded as the plain version rounds them) are summed in
float64, and the epilogue joins them as the kernel does: l2 as (T -
|q|^2 held on T's grid, exact; the mirror asserts it) - |x|^2, then the
small terms; ip and angular (reciprocals of the norms multiplied) by one
float32 sum. ``codes_to_bf16_bits`` is the kernel's conversion of a
code to bf16 bits (a byte permute, two masks and a bf16 subtraction).
Both are test-only mirrors, not used by the port.

``chained_scores`` is the arithmetic the kernel had before: the three
pieces ``bf16(u)``, ``bf16(u - u1)``, ``bf16(u - u1 - u2)`` chained
through one accumulator per slice (under the same model of the tensor
cores), float32 norms. Under that model it drifts by about 1e-4 at phase
4's scores, as the card's kernel did (``PERF.md``).

Tolerances: the kernel family's own. Against the JAX oracle and its numpy
twin, 1e-5 of the largest |score| everywhere (``chip_smoke.QUANT_TOL``),
and elementwise rtol = atol = 1e-5 on the reference test's shapes and the
card test's ``QUANT_SHAPES``, where d <= 16 (float32 sums in another
order; at d = 130 and above, two float32 orders part by more than 1e-5 of
a score near zero, so the wide shapes are held to the first gate only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantParams
from repro.kernels.quant_distance import quant_scores_np, quant_scores_ref
from repro.kernels.quant_distance.kernel import quant_distance_pallas
from repro_torch.kernels.quant_distance import \
    quant_scores as torch_quant_scores

METRICS = ("l2", "ip", "angular")
TILE_Q = 128   # queries of a block
TILE_N = 64    # rows of a tile
SLICE = 128    # columns of d a stage holds
STEP = 16      # columns of an mma k-step
EPS = 1e-12


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def split_fixed(u: torch.Tensor):
    """The kernel's split of u [B, d] float32: E from each row's largest
    |u_k| (|u_k| < 2^E), v = u 2^-E, p1 = rint(v 2^8) 2^-8, p2 =
    rint((v - p1) 2^16) 2^-16, p3 = rint((v - p1 - p2) 2^24) 2^-24, each
    step exact in float32 but the last rounding. Returns ((p1, p2, p3),
    E [B, 1] as integers)."""
    mx = u.abs().amax(dim=1, keepdim=True)
    e = torch.frexp(mx).exponent.clamp(-125, 126)
    v = torch.ldexp(u, -e)
    p1 = torch.round(v * 256.0) / 256.0
    r1 = v - p1
    p2 = torch.round(r1 * 65536.0) / 65536.0
    p3 = torch.round((r1 - p2) * 2.0 ** 24) / 2.0 ** 24
    return (p1, p2, p3), e


def split3(u: torch.Tensor):
    """The earlier split: u1 = bf16(u), u2 = bf16(u - u1), u3 = bf16(u -
    u1 - u2), each remainder taken in float32."""
    u1 = bf16(u)
    r = u - u1
    u2 = bf16(r)
    return u1, u2, bf16(r - u2)


def toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero, as the tensor cores round
    an instruction's sum."""
    f = v.to(torch.float32)
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def codes_to_bf16_bits(c: np.ndarray) -> np.ndarray:
    """int8 codes -> bf16 bits as the kernel makes them: with 0x43 as the
    high byte, (0x43, c & 0x7f) is 128 + (c & 0x7f) and (0x43, c & 0x80)
    is 128 or 256 by c's sign bit; their bf16 difference is c."""
    byte = np.asarray(c, np.int8).view(np.uint8).astype(np.uint32)
    raw = 0x4300 | byte
    lo7 = (raw & 0xFF7F) << 16
    sub = (raw & 0xFF80) << 16
    diff = lo7.view(np.float32) - sub.view(np.float32)   # exact
    return (diff.view(np.uint32) >> 16).astype(np.uint16)


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=t.dtype)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _inputs(q, codes, scale, zero):
    return (torch.as_tensor(np.asarray(q, np.float32)),
            torch.as_tensor(np.asarray(codes, np.int8)),
            torch.as_tensor(np.asarray(scale, np.float32)),
            torch.as_tensor(np.asarray(zero, np.float32)))


def _slices(pieces, cb, dp, accumulators):
    """Per slice of 128 columns, the k-steps' instructions into the
    accumulators (``accumulators``: for each accumulator, the pieces it
    takes in a k-step, in order, and whether it must stay exact), each
    instruction rounded toward zero; the slices' accumulators in a list."""
    bp, np_ = pieces[0].shape[0], cb.shape[0]
    out = []
    for k0 in range(0, dp, SLICE):
        accs = [torch.zeros((bp, np_), dtype=torch.float32)
                for _ in accumulators]
        for ks in range(k0, min(k0 + SLICE, dp), STEP):
            cols = slice(ks, ks + STEP)
            for i, (which, exact) in enumerate(accumulators):
                for j in which:
                    total = accs[i].double() + \
                        pieces[j][:, cols].double() @ cb[:, cols].double().T
                    accs[i] = toward_zero(total)
                    if exact:
                        assert torch.equal(accs[i].double(), total)
        out.append(accs)
    return out


def _row_norms(x_hat: torch.Tensor) -> torch.Tensor:
    """|x|^2 in float64 as the producer sums it: each slice's two halves
    of 64 columns, each half on its own thread over the slices, then the
    halves added."""
    d = x_hat.shape[1]
    halves = torch.zeros((2, x_hat.shape[0]), dtype=torch.float64)
    x64 = x_hat.double()
    for k0 in range(0, d, SLICE):
        for h in range(2):
            cols = slice(k0 + 64 * h, min(k0 + 64 * h + 64, d))
            halves[h] += (x64[:, cols] * x64[:, cols]).sum(dim=1)
    return halves[0] + halves[1]


def quant_scores_mirror(q, codes, scale, zero, *, metric: str):
    """q [B, d] float32, codes [n, d] int8, scale and zero [d] -> [B, n]
    float32, as the kernel computes it."""
    q, c8, scale, zero = _inputs(q, codes, scale, zero)
    b, d = q.shape
    n = c8.shape[0]
    dp = -(-d // STEP) * STEP
    bp, np_ = -(-b // TILE_Q) * TILE_Q, -(-n // TILE_N) * TILE_N
    (p1, p2, p3), e = split_fixed(_pad(q * scale, bp, dp))
    for piece in (p1, p2, p3):
        assert torch.equal(bf16(piece), piece)
    cb = bf16(_pad(c8, np_, dp).to(torch.float32))    # exact
    # v1 in its own exact accumulator; v3 then v2 in the other
    slices = _slices((p1, p2, p3), cb, dp, (((0,), True), ((2, 1), False)))
    s1, s23 = slices[-1]
    if len(slices) > 1:
        run = torch.zeros_like(s1)
        for a1, a23 in slices[:-1]:
            run = run + (a1 + a23)
        s1 = run + s1
    s1, s23 = s1[:b, :n], s23[:b, :n]
    e = e[:b]
    q64 = q.double()
    qn = (q64 * q64).sum(dim=1)
    qz = (q64 * zero.double()).sum(dim=1)
    qn_hi = qn.to(torch.float32)
    x_hat = c8.to(torch.float32) * scale + zero      # the plain rounding
    xn = _row_norms(x_hat)
    xn_hi = xn.to(torch.float32)
    if metric == "l2":
        k0 = torch.ldexp(torch.ones_like(qn_hi), e[:, 0] + 1)[:, None]
        grid = torch.ldexp(torch.ones_like(qn), e[:, 0] - 7)
        k1 = (torch.round(qn / grid) * grid).to(torch.float32)[:, None]
        k2 = (2.0 * qz - (qn - k1[:, 0].double())).to(torch.float32)[:, None]
        big = s1 * k0
        h = big - k1
        if len(slices) == 1:        # T and |q|^2 on one grid: exact
            assert torch.equal(h.double(), big.double() - k1.double())
        small = (s23 * k0 + k2) - (xn - xn_hi.double()).to(
            torch.float32)[None, :]
        return (h - xn_hi[None, :]) + small
    k0 = torch.ldexp(torch.ones_like(qn_hi), e[:, 0])[:, None]
    dot = s1 * k0 + (s23 * k0 + qz.to(torch.float32)[:, None])
    if metric == "ip":
        return dot
    if metric == "angular":      # reciprocals of the norms, multiplied
        return (dot * (1.0 / (torch.sqrt(qn_hi) + EPS))[:, None]
                * (1.0 / (torch.sqrt(xn_hi) + EPS))[None, :])
    raise ValueError(metric)


def chained_scores(q, codes, scale, zero):
    """l2 scores under the kernel's earlier arithmetic (``split3``'s
    pieces chained through one accumulator, smallest first each k-step;
    |q|^2, q.z and |x|^2 summed in float32), with the tensor cores
    modelled as in ``quant_scores_mirror``."""
    q, c8, scale, zero = _inputs(q, codes, scale, zero)
    b, d = q.shape
    n = c8.shape[0]
    dp = -(-d // STEP) * STEP
    pieces = split3(_pad(q * scale, b, dp))
    cb = bf16(_pad(c8, n, dp).to(torch.float32))
    total = torch.zeros((b, n), dtype=torch.float32)
    for (acc,) in _slices(pieces, cb, dp, (((2, 1, 0), False),)):
        total = total + acc
    x_hat = c8.to(torch.float32) * scale + zero
    dot = total + (q * zero).sum(dim=1)[:, None]
    return (2.0 * dot - (q * q).sum(dim=1)[:, None]) - \
        (x_hat * x_hat).sum(dim=1)[None, :]


def _reference_case(b, n, d, seed):
    """The JAX kernel test's inputs (tests/test_kernel_quant_distance.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * \
        rng.uniform(0.5, 3.0, size=(1, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    params = QuantParams.from_data(x)
    return q, params.quantize(x), params.scale, params.zero


def _card_case(b, n, d, seed):
    """The card test's recipe (tests/test_torch_cuda.py ``_quant_case``),
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * (0.5 + 2.5 * rng.random((1, d)))
         ).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    lo, hi = x.min(axis=0), x.max(axis=0)
    scale = np.maximum((hi - lo) / np.float32(254.0),
                       np.float32(1e-12)).astype(np.float32)
    zero = ((hi + lo) / np.float32(2.0)).astype(np.float32)
    codes = np.clip(np.round((x - zero) / scale), -127, 127).astype(np.int8)
    return q, codes, scale, zero


def _jax_scores(q, codes, scale, zero, metric):
    return np.asarray(quant_scores_ref(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale),
        jnp.asarray(zero), metric=metric))


def _hold(got, want, *, elementwise: bool):
    got = np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
    if elementwise:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d", [(5, 24, 8), (130, 70, 16), (1, 8, 4),
                                   (37, 53, 8)])
def test_mirror_matches_jax_on_reference_cases(metric, b, n, d):
    q, codes, scale, zero = _reference_case(b, n, d, seed=b * n + d)
    got = quant_scores_mirror(q, codes, scale, zero, metric=metric)
    _hold(got, _jax_scores(q, codes, scale, zero, metric), elementwise=True)
    _hold(got, quant_scores_np(q, codes, scale, zero, metric=metric),
          elementwise=True)


@pytest.mark.parametrize("metric", METRICS)
def test_mirror_matches_pallas_kernel_blocked(metric):
    """The Pallas kernel in interpret mode, on the reference's blocked
    launch shape."""
    q, codes, scale, zero = _reference_case(37, 53, 8, seed=7)
    want = np.asarray(quant_distance_pallas(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale),
        jnp.asarray(zero), metric=metric, interpret=True, block_q=16,
        block_n=16))
    _hold(quant_scores_mirror(q, codes, scale, zero, metric=metric), want,
          elementwise=True)


# the card test's QUANT_SHAPES: held elementwise (d <= 16)
CARD_SHAPES = [(5, 24, 8), (130, 70, 16), (1, 8, 4), (37, 53, 8),
               (65, 129, 3), (1, 1, 1), (130, 300, 16), (257, 129, 8)]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_mirror_on_card_shapes(metric, shape):
    b, n, d = shape
    q, codes, scale, zero = _card_case(b, n, d, seed=b * n + d)
    _hold(quant_scores_mirror(q, codes, scale, zero, metric=metric),
          quant_scores_np(q, codes, scale, zero, metric=metric),
          elementwise=True)


# shapes that cross the tiles and slices: B and n off the 128 tiles, d off
# the 16-column step (130: two slices, the second ragged), the kNN-LM
# width (2,048: 16 slices), and the main path's d = 128 in one slice
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(129, 257, 130), (33, 65, 2048),
                                   (200, 300, 128)], ids=str)
def test_mirror_on_wide_rows(metric, shape):
    b, n, d = shape
    q, codes, scale, zero = _card_case(b, n, d, seed=b + n + d)
    got = quant_scores_mirror(q, codes, scale, zero, metric=metric)
    _hold(got, quant_scores_np(q, codes, scale, zero, metric=metric),
          elementwise=False)
    _hold(got, _jax_scores(q, codes, scale, zero, metric),
          elementwise=False)


def test_mirror_on_offset_rows():
    """Rows far from the origin (every zero-point large against the
    range): the folded q.z and the folded sum meet at the end."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(300, 128)) * 0.1 + 4.0).astype(np.float32)
    q = rng.normal(size=(40, 128)).astype(np.float32)
    params = QuantParams.from_data(x)
    codes = params.quantize(x)
    for metric in METRICS:
        _hold(quant_scores_mirror(q, codes, params.scale, params.zero,
                                  metric=metric),
              quant_scores_np(q, codes, params.scale, params.zero,
                              metric=metric), elementwise=False)


def test_every_int8_value_is_exact_in_bf16():
    c = np.arange(-128, 128, dtype=np.int8)
    as_bf16 = bf16(torch.as_tensor(c, dtype=torch.float32))
    assert torch.equal(as_bf16, torch.as_tensor(c, dtype=torch.float32))
    bits = codes_to_bf16_bits(c).astype(np.uint32) << 16
    np.testing.assert_array_equal(bits.view(np.float32),
                                  c.astype(np.float32))


@pytest.mark.parametrize("log10_scale", (-20, -6, 0, 6, 20))
def test_three_pieces_carry_every_bit(log10_scale):
    """The fixed-point pieces carry v = u 2^-E to within 2^-25 (every bit
    of v on the grid 2^-24, rounded), each is exact in bf16, a piece
    times any code is exact in float32, and the first piece's products
    summed over a whole slice stay exact in float32 (at most 2^22 units
    of 2^-8)."""
    rng = np.random.default_rng(log10_scale + 40)
    u = torch.as_tensor((rng.normal(size=(4, 4096)) * 10.0 ** log10_scale)
                        .astype(np.float32))
    (p1, p2, p3), e = split_fixed(u)
    v = torch.ldexp(u.double(), -e)
    assert bool((v.abs() < 1).all())
    total = p1.double() + p2.double() + p3.double()
    assert float((total - v).abs().max()) <= 2.0 ** -25
    c = torch.arange(-128, 128, dtype=torch.float32)
    for piece in (p1, p2, p3):
        assert torch.equal(bf16(piece), piece)
        prod = piece[:, :, None] * c
        assert torch.equal(prod.double(), piece.double()[:, :, None]
                           * c.double())
    worst = (p1[:, :SLICE].abs() * 256.0 * 128.0).sum(dim=1)
    assert float(worst.max()) <= 2.0 ** 22


def test_two_pieces_would_not_do():
    """p1 + p2 leaves up to 2^-17 of the row's power of two behind, more
    than float32's rounding of u: the third piece is needed."""
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.normal(size=(1, 4096)).astype(np.float32))
    (p1, p2, _), e = split_fixed(u)
    v = torch.ldexp(u.double(), -e)
    left = float((p1.double() + p2.double() - v).abs().max())
    assert 2.0 ** -24 < left <= 2.0 ** -17


def test_port_plain_version_agrees_with_mirror():
    """On the CPU the port's entry point takes the plain version; the
    mirror and it agree to the family's gate."""
    q, codes, scale, zero = _card_case(70, 200, 130, seed=9)
    for metric in METRICS:
        plain = torch_quant_scores(
            torch.as_tensor(q), torch.as_tensor(codes),
            torch.as_tensor(scale), torch.as_tensor(zero), metric=metric)
        _hold(quant_scores_mirror(q, codes, scale, zero, metric=metric),
              plain.numpy(), elementwise=False)


def float64_l2_scores(q, codes, scale, zero) -> torch.Tensor:
    """The function the int8 scan approximates, exactly: l2 scores
    ``2 x.q - |q|^2 - |x|^2`` in float64 of the rows dequantized as the
    plain version dequantizes them (``c * scale + zero`` in float32)."""
    x_hat = (torch.as_tensor(np.asarray(codes, np.int8)).to(torch.float32)
             * torch.as_tensor(scale) + torch.as_tensor(zero)).double()
    q64 = torch.as_tensor(np.asarray(q, np.float32)).double()
    return (2.0 * q64 @ x_hat.T - (q64 * q64).sum(dim=1)[:, None]
            - (x_hat * x_hat).sum(dim=1)[None, :])


# phase 4's int8 scan at n rows (chip_smoke.int8_scan): the plain float32
# version's only misses against float64's top-10 of the first 64 queries,
# as (query, rank, plain's row, float64's row)
PHASE4_PLAIN_MISSES = {
    20_000: [(8, 3, 16521, 11802), (8, 4, 11802, 16521)],  # a near tie
    32_000: [],
    50_000: [(43, 9, 6640, 39116)],      # an exact tie in float32
}


def _phase4_case(n: int):
    from repro_torch.core.quant import QuantParams as TorchQuantParams
    from repro_torch.data.synthetic import clustered_vectors, query_set
    x = clustered_vectors(n, 128, 1000, seed=0)
    q = query_set(x, 1024, seed=1)[:64]
    params = TorchQuantParams.from_data([x])
    return q, params.quantize(x), params.scale, params.zero


@pytest.mark.parametrize("n", sorted(PHASE4_PLAIN_MISSES))
def test_mirror_top10_equals_float64_on_phase4_scan(n):
    """The grid and codes as the int8 arena builds them from phase 4's
    vectors: the kernel's arithmetic ranks the top 10 of each of the
    first 64 queries as float64 does, at every position; the plain
    float32 version misorders a near tie (n = 20,000: query 8's ranks 3
    and 4, float64 scores 1.7e-6 apart) or breaks an exact float32 tie
    the other way (n = 50,000)."""
    q, codes, scale, zero = _phase4_case(n)
    exact = float64_l2_scores(q, codes, scale, zero)
    want = torch.topk(exact, 10, dim=1).indices
    mirror = quant_scores_mirror(q, codes, scale, zero, metric="l2")
    assert torch.equal(torch.topk(mirror, 10, dim=1).indices, want)
    plain = torch_quant_scores(
        torch.as_tensor(q), torch.as_tensor(codes), torch.as_tensor(scale),
        torch.as_tensor(zero), metric="l2")
    got = torch.topk(plain, 10, dim=1).indices
    misses = [(qi, j, int(got[qi, j]), int(want[qi, j]))
              for qi, j in (got != want).nonzero().tolist()]
    assert misses == PHASE4_PLAIN_MISSES[n]


def test_fixed_point_pieces_beat_the_chained_sum_on_phase4_scan():
    """At phase 4's 32,000 rows, scored against float64: the chained
    accumulator of the earlier arithmetic drifts by more than 1e-4 at the
    top 10 (the card's kernel was about 1.2e-4 off there and swapped query
    45's ranks 7 and 8, 3.4e-5 apart); the fixed-point pieces stay within
    1.5e-5 of float64 at the top 10 and within the plain float32
    version's error over all rows."""
    q, codes, scale, zero = _phase4_case(32_000)
    exact = float64_l2_scores(q, codes, scale, zero)
    top = torch.topk(exact, 10, dim=1).indices

    def errors(scores):
        err = (scores.double() - exact).abs()
        return float(err.max()), float(err.gather(1, top).max())
    mirror = errors(quant_scores_mirror(q, codes, scale, zero, metric="l2"))
    chained = errors(chained_scores(q, codes, scale, zero))
    plain = errors(torch_quant_scores(
        torch.as_tensor(q), torch.as_tensor(codes), torch.as_tensor(scale),
        torch.as_tensor(zero), metric="l2"))
    assert chained[1] > 1e-4
    assert mirror[1] <= 1.5e-5
    assert mirror[0] <= plain[0]
    gap = exact[45].gather(0, top[45])
    assert float(gap[7] - gap[8]) < 3.5e-5
