"""Parameter derivation: the port's own copy of ``labrador_tpu/params.py``.

Pure Python with f64 semantics identical to Rust's, reproducing the
reference's ``RuntimeConstants::new`` (``constants.rs:234-264``) and the
JAX package's extensions over it (``kappa_override``, ``exact_digits``,
``beta_override``), plus the internal CRT prime selection.  Conventions
kept from the reference (``constants.rs:249-254``): ``gamma``, ``gamma_1``,
``gamma_2`` and ``beta_prime`` are stored squared, and ``b_1`` is
truncated, not rounded.  The tests hold every derived field equal to the
JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

# Ring degree: Rq = Zq[X]/(X^D + 1)  (constants.rs:15).
D = 64

# Challenge space for D = 64 (constants.rs:22-23): TAU = ||c||^2, T_OPNORM
# the operator-norm rejection bound.
TAU = 71.0
T_OPNORM = 15.0

# |F| and |F'| of the principal relation (constants.rs:26,32).
K_DEFAULT = 1
L_DEFAULT = 1

# Modulus search start: (1 << 13) - 1 -> q = 8191 (constants.rs:195).
Q_START_DEFAULT = (1 << 13) - 1

# Largest internal CRT prime (= ops.modmath.P_MAX).
_CRT_PRIME_CAP = 32513


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, exact below 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_suitable_prime(start: int) -> int:
    """Smallest prime >= start (the live path of constants.rs:45-87)."""
    q = start
    while not _is_prime(q):
        q += 1
    return q


@lru_cache(maxsize=None)
def ntt_prime_table(d: int = D, max_val: int = _CRT_PRIME_CAP) -> tuple[int, ...]:
    """All primes p <= max_val with p = 1 (mod 2d), descending: the internal
    CRT primes of the exact negacyclic convolution."""
    out = []
    step = 2 * d
    p = ((max_val - 1) // step) * step + 1
    while p > step:
        if _is_prime(p):
            out.append(p)
        p -= step
    return tuple(out)


def select_crt_primes(q: int, d: int = D,
                      max_accum: int = 1 << 20) -> tuple[int, ...]:
    """The largest CRT primes, in descending order, until their product
    exceeds 2 * max_accum * d * (q-1)^2 (the signed range of the longest
    contraction folded into the evaluation domain before reconstruction)."""
    bound = 2 * max_accum * d * (q - 1) ** 2
    primes: list[int] = []
    prod = 1
    for p in ntt_prime_table(d):
        if prod > bound:
            break
        primes.append(p)
        prod *= p
    if prod <= bound:
        raise ValueError(f"not enough {d}-NTT primes below 2^15 for q={q}")
    return tuple(primes)


@dataclass(frozen=True)
class LabradorParams:
    """Frozen parameter set.  ``n``: rank of each witness vector (ring
    elements); ``r``: number of witness vectors.  Overrides (all default to
    the reference's behaviour):

    * ``kappa_override``: constant Ajtai rank instead of kappa = n * d;
    * ``exact_digits``: digit counts ceil(log_b q), so balanced digits
      reconstruct exactly (recursion needs it), with the exact-mode beta'^2;
    * ``beta_override``: explicit witness norm bound (a folded instance
      carries its digit-stream norm).
    """

    n: int
    r: int
    q: int = 0                    # 0 -> derive from q_start
    d: int = D
    k_count: int = K_DEFAULT
    l_count: int = L_DEFAULT
    q_start: int = Q_START_DEFAULT
    kappa_override: int = 0
    exact_digits: bool = False
    beta_override: int = 0

    beta_bound: int = field(init=False, default=0)
    std: float = field(init=False, default=0.0)
    b: int = field(init=False, default=0)
    t_1: int = field(init=False, default=0)
    b_1: int = field(init=False, default=0)
    t_2: int = field(init=False, default=0)
    b_2: int = field(init=False, default=0)
    gamma: float = field(init=False, default=0.0)        # squared
    gamma_1: float = field(init=False, default=0.0)      # squared
    gamma_2: float = field(init=False, default=0.0)      # squared
    beta_prime: float = field(init=False, default=0.0)   # squared
    kappa: int = field(init=False, default=0)
    kappa_1: int = field(init=False, default=0)
    kappa_2: int = field(init=False, default=0)
    crt_primes: tuple[int, ...] = field(init=False, default=())

    def __post_init__(self):
        def put(name, value):
            object.__setattr__(self, name, value)

        q = self.q if self.q else find_suitable_prime(self.q_start)
        put("q", q)
        n, r, d = self.n, self.r, self.d

        # constants.rs:237-239
        kappa = self.kappa_override if self.kappa_override else n * d
        put("kappa", kappa)
        put("kappa_1", kappa)
        put("kappa_2", kappa)

        # constants.rs:241-243
        beta = self.beta_override or \
            math.floor(math.sqrt(30.0 / 128.0) * float(q) / 125.0)
        put("beta_bound", int(beta))
        std = float(beta) / math.sqrt(float(r * n * d))
        put("std", std)
        b = _rust_round(math.sqrt(math.sqrt(12.0 * float(r) * TAU) * std))
        b = max(int(b), 2)
        put("b", b)
        # constants.rs:244-247 (digit counts clamped >= 1)
        t_1 = max(1, _rust_round(math.log2(float(q)) / math.log2(float(b))))
        b_1 = int(float(q) ** (1.0 / float(t_1)))
        t_2 = max(1, _rust_round(
            math.log2(math.sqrt(24.0 * float(n * d)) * std**2)
            / math.log2(float(b))))
        b_2 = _rust_round(
            (math.sqrt(float(24 * n * d)) * std**2) ** (1.0 / float(t_2)))
        b_2 = max(int(b_2), 2)
        if self.exact_digits:
            b_1 = max(b_1, 2)
            t_1 = _ceil_log(q, b_1)
            t_2 = _ceil_log(q, b_2)
        put("t_1", int(t_1))
        put("b_1", int(b_1))
        put("t_2", int(t_2))
        put("b_2", int(b_2))

        # constants.rs:250-254, all four squared
        gamma = float(beta * beta) * TAU
        gamma_1 = (float(b_1) ** 2 * float(t_1) / 12.0) * float(r) \
            * float(kappa) * float(d) + (float(b_2) ** 2 * float(t_2) / 12.0) \
            * ((float(r) ** 2 + float(r)) / 2.0) * float(d)
        gamma_2 = (float(b_1) ** 2 * float(t_1) / 12.0) * (
            (float(r) ** 2 + float(r)) / 2.0) * float(d)
        beta_prime = (2.0 / float(b) ** 2) * gamma + gamma_1 + gamma_2
        if self.exact_digits:
            # digit-norm budget of the z, t, g and h digit streams (g and h
            # over the full r x r matrices) with 4/3 slack; see the JAX
            # package's params.py for the derivation
            nz = _ceil_log(q, b)
            budget = (_digit_budget_sq(q, b, nz, n * d)
                      + _digit_budget_sq(q, b_1, t_1, r * kappa * d)
                      + _digit_budget_sq(q, b_2, t_2, r * r * d)
                      + _digit_budget_sq(q, b_1, t_1, r * r * d))
            bp_int = int(math.ceil(budget * 4.0 / 3.0))
            assert bp_int < 2**53, "beta'^2 exceeds f64 integer range"
            beta_prime = float(bp_int)
        put("gamma", gamma)
        put("gamma_1", gamma_1)
        put("gamma_2", gamma_2)
        put("beta_prime", beta_prime)

        # longest contraction before CRT reconstruction: the u1 outer
        # commitment's r * t_1 * kappa terms, 2x headroom, floor 1024
        put("crt_primes", select_crt_primes(
            q, d, max_accum=max(2 * r * t_1 * kappa, 1024)))

    @property
    def upper_bound(self) -> int:
        """First-aggregation rounds: min(K, ceil(128 / log2 q))
        (proofgen.rs:189)."""
        return min(self.k_count, math.ceil(128.0 / math.log2(float(self.q))))

    @property
    def inv2(self) -> int:
        """2^-1 mod q (the h matrix, proofgen.rs:341-346)."""
        return pow(2, self.q - 2, self.q)


def _digit_budget_sq(q: int, base: int, ndig: int, count: int) -> float:
    """Squared-norm budget of ``count`` centred values' balanced base-``base``
    digit streams of length ``ndig``: per position, count * min(E[d^2] of a
    uniform digit, cap^2), cap the position's attainable maximum."""
    b = int(base)
    e_uniform = sum((v if v <= b // 2 else v - b) ** 2 for v in range(b)) / b
    m = q // 2
    total = 0.0
    for _ in range(int(ndig)):
        cap = min(b // 2, m)
        total += count * min(e_uniform, float(cap * cap))
        m = (m + b // 2) // b
    return total


def _ceil_log(q: int, b: int) -> int:
    """Smallest t with b**t >= q."""
    t = 1
    v = b
    while v < q:
        v *= b
        t += 1
    return t


def _rust_round(x: float) -> int:
    """Rust f64::round(): half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))
