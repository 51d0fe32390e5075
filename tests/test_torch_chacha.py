"""The port's ChaCha20 generator (``labrador_tpu_torch/native``) and its
reference-parity CRS (``crs.MaterializedCRS``) against the JAX package's.

The generator: the RFC 8439 keystream vector and the cases of
``tests/test_native.py`` (offset shift, seed carry), and coefficients
equal to ``labrador_tpu.native.crs_coeffs`` at a few offsets and two
moduli.  The CRS: ``MaterializedCRS.create_chacha`` at config 1 (n = r =
2, q = 8191, kappa = 128, the reference's ``main.rs`` demo) equals the JAX
class's table, key and every fetcher, reads beyond the table (0) and a C
read past ``_off_d`` included.  Tolerance: exact.  No JAX compile: the JAX
table is host C++ and ``jnp.asarray``, its fetchers eager slices and
gathers.  On a card (no JAX there), ``python -m pytest
tests/test_torch_chacha.py -m cuda --noconftest`` holds the kernels' table
modes against their plain versions.
"""

import numpy as np
import pytest
import torch

from labrador_tpu_torch import native
from labrador_tpu_torch.crs import CRS, MaterializedCRS, _used_intervals
from labrador_tpu_torch.params import LabradorParams

P = LabradorParams(n=2, r=2)
SEED = bytes(range(32))


def test_chacha20_rfc_vector():
    """RFC 8439 (draft-agl-tls-chacha20poly1305 TC1): zero key and nonce,
    counter 0; counter 1 gives another block."""
    ks = native.chacha20_keystream(b"\x00" * 32, 0)
    assert ks.astype("<u4").tobytes()[:16].hex() == \
        "76b8e0ada0f13d90405d6ae55386bd28"
    assert (native.chacha20_keystream(b"\x00" * 32, 1) != ks).any()


def test_crs_coeffs_offset_shift_and_range():
    """Coefficient o + 1 is the first of a fetch from o + 1 (one re-key a
    coefficient, structs.rs:147-171); values lie in [0, q)."""
    a = native.crs_coeffs(b"\x03" * 32, 100, 8, 8191)
    b = native.crs_coeffs(b"\x03" * 32, 101, 8, 8191)
    np.testing.assert_array_equal(a[1:], b[:-1])
    assert (a >= 0).all() and (a < 8191).all()


def test_seed_carry_propagation():
    """base + offset carries across bytes as the big-endian BigUint does."""
    a = native.crs_coeffs(bytes([0] * 31 + [0xFF]), 1, 1, 8191)
    b = native.crs_coeffs(bytes([0] * 30 + [0x01, 0x00]), 0, 1, 8191)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [8191, 32513])
@pytest.mark.parametrize("offset", [0, 1, 255, 65_535, 1 << 33])
def test_crs_coeffs_match_jax(q, offset):
    """The port's coefficients equal the JAX package's generator's."""
    from labrador_tpu.native import crs_coeffs as jax_crs_coeffs
    np.testing.assert_array_equal(
        native.crs_coeffs(SEED, offset, 300, q),
        jax_crs_coeffs(SEED, offset, 300, q))


def test_crs_coeffs_threaded_match_jax():
    """A range long enough to be split over host threads equals the JAX
    package's generator, which runs it in one call."""
    from labrador_tpu.native import crs_coeffs as jax_crs_coeffs
    np.testing.assert_array_equal(native.crs_coeffs(SEED, 7, 3 << 16, 8191),
                                  jax_crs_coeffs(SEED, 7, 3 << 16, 8191))


@pytest.fixture(scope="module")
def both():
    """(JAX MaterializedCRS, the port's) at config 1 from one base seed."""
    from labrador_tpu.crs import MaterializedCRS as JaxMaterializedCRS
    from labrador_tpu.params import LabradorParams as JaxParams
    jcrs = JaxMaterializedCRS.create_chacha(JaxParams(n=2, r=2), SEED)
    return jcrs, MaterializedCRS.create_chacha(P, SEED, device="cpu")


def test_table_and_key_match_jax(both):
    jcrs, crs = both
    assert crs.coeffs.dtype == torch.int32
    np.testing.assert_array_equal(crs.coeffs.numpy(), np.asarray(jcrs.coeffs))
    assert crs.key == tuple(int(w) for w in np.asarray(jcrs.key))
    assert crs.key == (0x00010203, 0x04050607)
    # zeros in the gap between the intervals the protocol reads
    (_, b_end), (off_c, _) = _used_intervals(P)
    assert not crs.coeffs[b_end:off_c].any()


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


def test_fetchers_match_jax(both):
    """Every fetcher equals the JAX class's: A, B (static and dynamic), C,
    D and the dynamic C/D columns, a C read past _off_d, and a dynamic
    read past the table's end (0)."""
    jcrs, crs = both
    p = P
    cpu = "cpu"
    _eq(crs.a_rows(device=cpu), jcrs.a_rows())
    _eq(crs.a_rows(5, 3, device=cpu), jcrs.a_rows(5, 3))
    _eq(crs.a_rows_dyn(7, 4, device=cpu), jcrs.a_rows_dyn(7, 4))
    for i in range(p.r):
        for k in range(p.t_1):
            _eq(crs.b_rows(i, k, device=cpu), jcrs.b_rows(i, k))
    _eq(crs.b_rows(1, 2, 3, 5, device=cpu), jcrs.b_rows(1, 2, 3, 5))
    m_last = p.r * p.t_1 - 1
    _eq(crs.b_mat_dyn(m_last, device=cpu), jcrs.b_mat_dyn(m_last))
    _eq(crs.b_mat_dyn(3, col0=17, ncols=9, device=cpu),
        jcrs.b_mat_dyn(3, col0=17, ncols=9))
    for i in range(p.r):
        for j in range(i, p.r):
            for k in range(p.t_2):
                _eq(crs.c_vec(i, j, k, device=cpu), jcrs.c_vec(i, j, k))
            for k in range(p.t_1):
                _eq(crs.d_vec(i, j, k, device=cpu), jcrs.d_vec(i, j, k))
    # the last C column sits past _off_d (the t_1 quirk, structs.rs:106)
    assert crs._c_start(p.r - 1, p.r - 1, p.t_2 - 1) > crs._off_d
    col = p.kappa_2 * p.d
    n_tri = p.r * (p.r + 1) // 2
    for base in (crs._off_c, crs._off_d):
        oc = p.t_1 * (n_tri - 1) + p.t_2 - 1
        _eq(crs._expand_dyn(base, oc, col, (p.kappa_2, p.d), (p.d, 1),
                            device=cpu),
            jcrs._expand_dyn(base, oc, col, (p.kappa_2, p.d), (p.d, 1)))
    # a tile that runs past the table's end reads 0 there, as jnp.take's
    # fill mode
    total = crs.coeffs.numel()
    start = total - 100
    got = crs._expand_dyn(start, 0, 0, (3, 64), (64, 1), device=cpu)
    _eq(got, jcrs._expand_dyn(start, 0, 0, (3, 64), (64, 1)))
    assert not got.reshape(-1)[100:].any() and got.reshape(-1)[:100].any()


def test_big_q_refused():
    with pytest.raises(ValueError, match="small q"):
        MaterializedCRS.create_chacha(
            LabradorParams(n=2, r=2, q_start=(1 << 32) - 1), SEED,
            device="cpu")


def test_interop_carries_the_jax_crs(both):
    from labrador_tpu_torch.interop import materialized_crs_from_numpy
    jcrs, crs = both
    got = materialized_crs_from_numpy(np.asarray(jcrs.coeffs),
                                      np.asarray(jcrs.key), P, device="cpu")
    assert torch.equal(got.coeffs, crs.coeffs) and got.key == crs.key


def test_wrappers_dispatch_on_the_crs():
    """A CRS that is neither Threefry nor a table raises in the kernel
    wrappers' dispatch, a table on another device or at big q too; the
    two CRS types pick their modes."""
    from labrador_tpu_torch.ops.ring_stream import entry_table
    cpu = torch.device("cpu")
    table = MaterializedCRS(coeffs=torch.zeros(8, dtype=torch.int32),
                            key=(1, 2), params=P)
    assert entry_table(table, cpu) is table.coeffs
    assert entry_table(CRS.create(P, seed=5), cpu) is None
    with pytest.raises(TypeError):
        entry_table(object(), cpu)
    with pytest.raises(ValueError, match="lies on"):
        entry_table(table, torch.device("meta"))
    big = LabradorParams(n=2, r=2, q_start=(1 << 32) - 1)
    with pytest.raises(ValueError, match="small q"):
        entry_table(MaterializedCRS(coeffs=table.coeffs, key=(1, 2),
                                    params=big), cpu)
    with pytest.raises(ValueError, match="int32"):
        entry_table(MaterializedCRS(coeffs=table.coeffs.long(), key=(1, 2),
                                    params=P), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["config1", "2^14"])
def test_cuda_table_modes_match_plain(shape):
    """On a card: each table mode (Ajtai, u1 B-term, C/D), whole and in a
    range shard, bit-equal to its plain version on the same table; config
    1 on its ChaCha table, 2^14 (n = r = 16, kappa = 256) on random
    residues of the layout's size (exactness does not depend on ChaCha
    values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from labrador_tpu_torch.ops import ajtai_cuda, cd_cuda, u1_cuda
    from labrador_tpu_torch.protocol import _tri_stream
    if shape == "config1":
        p = P
        crs = MaterializedCRS.create_chacha(p, SEED, "cuda")
    else:
        p = LabradorParams(n=16, r=16, kappa_override=256)
        total = _used_intervals(p)[-1][1]
        gen = torch.Generator("cuda").manual_seed(11)
        crs = MaterializedCRS(
            coeffs=torch.randint(0, p.q, (total,), dtype=torch.int32,
                                 device="cuda", generator=gen),
            key=(1, 2), params=p)
    rng = np.random.default_rng(3)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to("cuda")

    def digits(base, shape_):
        return t(rng.integers(-(base // 2), base // 2 + 1, shape_) % p.q)

    w = t(rng.integers(0, p.q, (p.r, p.n, p.d)))
    t_dig = digits(p.b_1, (p.t_1, p.r, p.kappa, p.d))
    h_str = _tri_stream(digits(p.b_1, (p.t_1, p.r, p.r, p.d)), p)
    g_str = _tri_stream(digits(p.b_2, (p.t_2, p.r, p.r, p.d)), p)
    per, m = p.kappa // 4, h_str.shape[0] * p.t_1 // 4
    cases = [
        (ajtai_cuda.ajtai_commit, ajtai_cuda.ajtai_commit_plain, (w,)),
        (ajtai_cuda.ajtai_commit, ajtai_cuda.ajtai_commit_plain,
         (w, per, per)),
        (u1_cuda.u1_bterm, u1_cuda.u1_bterm_plain, (t_dig,)),
        (u1_cuda.u1_bterm, u1_cuda.u1_bterm_plain, (t_dig, per, per)),
        (lambda c, h: cd_cuda.cd_sum(c, h, c._off_d, p.t_1),
         lambda c, h: cd_cuda.cd_sum_plain(c, h, c._off_d, p.t_1), (h_str,)),
        (lambda c, h: cd_cuda.cd_sum(c, h, c._off_d, p.t_1, 0, m, m),
         lambda c, h: cd_cuda.cd_sum_plain(c, h, c._off_d, p.t_1, m, m),
         (h_str,)),
        (lambda c, g: cd_cuda.cd_sum(c, g, c._off_c, p.t_2, p.b_2),
         lambda c, g: cd_cuda.cd_sum_plain(c, g, c._off_c, p.t_2), (g_str,)),
    ]
    mods = (ajtai_cuda, u1_cuda, cd_cuda)
    for mod in mods:
        mod.KERNEL_TABLE.launches = 0
    for kern, plain, args in cases:
        assert torch.equal(kern(crs, *args), plain(crs, *args))
    assert [m_.KERNEL_TABLE.launches for m_ in mods] == [2, 2, 3]
