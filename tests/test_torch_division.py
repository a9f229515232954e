"""The phase-1 kernel's short division, written out in numpy.

``csrc/phase1.cu:short_div`` divides int64 ``num`` by ``den >= 1`` as
``q = floor(f32(num) * rcp)``, where ``rcp`` (``div_rcp``) is within two
ulp of ``1 / f32(den)`` (``__fdividef``; ``+inf`` from 2**62 on), keeps
``q`` when ``|q| < 2**20`` and corrects it once against the exact
remainder, computed in 32 bits where ``den <= 2**30`` and in 64 bits
otherwise; any other kept lane is divided again exactly.  numpy rounds
the conversions and the product as the card does (round to nearest
even); the reciprocal is taken at every value within two ulp of the
correctly rounded one, so the properties hold for whatever the card's
approximate reciprocal returns.  They are the kernel's exactness claims:

* wherever the short path is taken it equals floor division, over the
  whole operand range each site can see — ratio and balanced: any
  (wrapped) int64 numerator over a divisor in [1, 2**63); normalisation:
  an int32 numerator (100 * value, wrapped) over a row maximum in
  [1, 2**31);
* the range test sends every lane outside the proven range (quotient
  of 2**20 or more, divisor of 2**62 or more but for a zero numerator)
  to the exact path.

The kernel itself runs on the card: tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there.
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1
SHORT_Q = 2**20


ULPS = (-2, -1, 0, 1, 2)  # the reciprocal's error, in ulp


def rcp(den, ulps=0):
    """div_rcp: 1 / f32(den) moved by ``ulps`` ulp; +inf from 2**62 on."""
    den = np.asarray(den, np.int64)
    with np.errstate(divide="ignore"):
        r = np.float32(1) / den.astype(np.float32)
    toward = np.float32(np.inf if ulps > 0 else 0)
    for _ in range(abs(ulps)):
        r = np.nextafter(r, toward, dtype=np.float32)
    return np.where(den < 2**62, r, np.float32(np.inf)).astype(np.float32)


def short_division(num, den, ulps=0):
    """short_div: (quotient, taken) per lane."""
    num = np.asarray(num, np.int64)
    den = np.asarray(den, np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        f = np.floor(num.astype(np.float32) * rcp(den, ulps))  # float32 product
        # __float2int_rd: rounds down, saturates, NaN (0 * inf) -> 0.
        q = np.nan_to_num(f, nan=0.0, posinf=2**31 - 1, neginf=-(2**31))
        q = np.clip(q, -(2**31), 2**31 - 1).astype(np.int64)
    taken = np.abs(q) < SHORT_Q
    out = []
    for n, d, qi in zip(num.tolist(), den.tolist(), q.tolist()):
        if d <= 2**30:  # the remainder in 32 bits, wrapping
            r = (n - qi * d + 2**31) % 2**32 - 2**31
        else:  # in 64 bits, wrapping
            r = (n - qi * d + 2**63) % 2**64 - 2**63
        out.append(qi + (r >= d) - (r < 0))
    return np.array(out, dtype=object), taken


def check(nums, dens):
    for ulps in ULPS:
        got, taken = short_division(nums, dens, ulps)
        for n, d, g, t in zip(nums, dens, got, taken):
            want = n // d  # Python's floor division, exact
            if t:
                assert g == want, (n, d, ulps, g, want)
                # The range test let through only the proven range (and
                # 0 over a divisor past 2**62: 0 * inf is NaN, taken as 0).
                assert abs(want) <= SHORT_Q and (d < 2**62 or n == 0), (n, d, ulps)
            else:
                assert abs(want) >= SHORT_Q - 1 or d >= 2**62, (n, d, ulps)


wide_num = st.integers(INT64_MIN, INT64_MAX)
wide_den = st.integers(1, INT64_MAX)


@settings(max_examples=400, deadline=None)
@given(st.lists(st.tuples(wide_num, wide_den), min_size=1, max_size=64))
def test_ratio_and_balanced_sites_any_operands(pairs):
    nums, dens = zip(*pairs)
    check(list(nums), list(dens))


@settings(max_examples=400, deadline=None)
@given(
    st.lists(
        st.tuples(
            st.integers(-(SHORT_Q + 2), SHORT_Q + 2),  # quotient
            st.integers(1, 2**62 + 2**40),             # divisor
            st.floats(0, 1, exclude_max=True),         # remainder share
        ),
        min_size=1,
        max_size=64,
    )
)
def test_short_quotients_near_the_edges(triples):
    # Quotients up to and past 2**20, remainders anywhere in [0, den):
    # the lanes the short path must get right, and its boundary.
    nums, dens = [], []
    for q, d, share in triples:
        n = q * d + int(share * d)
        if INT64_MIN <= n <= INT64_MAX:
            nums.append(n)
            dens.append(d)
    if nums:
        check(nums, dens)


@settings(max_examples=400, deadline=None)
@given(
    st.lists(
        st.tuples(st.integers(-(2**31), 2**31 - 1), st.integers(1, 2**31 - 1)),
        min_size=1,
        max_size=64,
    )
)
def test_normalisation_site_int32_operands(pairs):
    # 100 * value wrapped to int32 over the row maximum, as the kernel.
    nums = [(v * 100 + 2**31) % 2**32 - 2**31 for v, _ in pairs]
    dens = [m for _, m in pairs]
    check(nums, dens)


def test_main_path_quotients_take_the_short_path():
    # Scores of sane inputs: quotients 0..100 over byte-scale divisors.
    rng = np.random.default_rng(0)
    dens = rng.integers(1, 2**45, 10_000)
    q = rng.integers(0, 101, 10_000)
    nums = q * dens + rng.integers(0, 2**45, 10_000) % dens
    for ulps in ULPS:
        got, taken = short_division(nums, dens, ulps)
        assert taken.all()
        assert np.array_equal(got.astype(np.int64), q)


def test_edges():
    cases = [
        (0, 1), (-1, 1), (1, 1), (INT64_MIN, 1), (INT64_MAX, 1),
        (INT64_MIN, INT64_MAX), (INT64_MAX, INT64_MAX), (-1, INT64_MAX),
        (2**62, 2**62 - 1), (-(2**62), 2**62 - 1), (2**62 - 1, 2**62), (5, 2**62),
        (SHORT_Q * 3 - 1, 3), (SHORT_Q * 3, 3), (-(SHORT_Q * 3) - 1, 3),
        (100 * (2**31 - 1), 2**31 - 1), (-100, 2**31 - 1), (2**31 - 1, 1),
    ]
    check([n for n, _ in cases], [d for _, d in cases])
