"""Protocol objects: constraint-system State and proof Transcript.

Counterpart of ``labrador_tpu/structs.py``, as dataclasses of int64
residue tensors at small and big q (the JAX package's two-limb ``Zq2``
fields are one int64 tensor here).  The bincode layout,
``transcript_size_in_bytes`` and ``save_transcript`` produce the same bytes
as the JAX package; at big q the challenges ``c`` are signed and bincode
writes them sign-extended, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from . import sampling
from .keys import Key, split
from .ops import ntt as ntt_ops
from .ops import zq
from .ops.modmath import mod_pos
from .params import LabradorParams


@dataclass
class State:
    """Families F and F' of the principal relation: a_k (K, r, r, d)
    symmetric in (i, j), phi_k (K, r, n, d), b_k (K, d); F' mirrors F with
    b'_k the constant coefficient of b_k (``structs.rs:352-374``)."""

    a_k: torch.Tensor
    phi_k: torch.Tensor
    b_k: torch.Tensor
    a_prime_k: torch.Tensor
    phi_prime_k: torch.Tensor
    b_prime_k: torch.Tensor


@dataclass
class Transcript:
    """All prover messages (``structs.rs:193-209``) plus the prover's two
    self-check flags."""

    u_1: torch.Tensor            # (kappa_1, d)
    pi: torch.Tensor             # (r, 256, n*d) int8 JL matrices
    projection: torch.Tensor     # (256,) mod q
    psi: torch.Tensor            # (upper_bound, L)
    omega: torch.Tensor          # (upper_bound, 256)
    b_prime_prime: torch.Tensor  # (upper_bound, d)
    alpha: torch.Tensor          # (K, d)
    beta: torch.Tensor           # (upper_bound, d)
    u_2: torch.Tensor            # (kappa_2, d)
    c: torch.Tensor              # (r, d)
    z: torch.Tensor              # (n, d)
    t: torch.Tensor              # (r, kappa, d)
    g: torch.Tensor              # (r, r, d)
    h: torch.Tensor              # (r, r, d)
    jl_ok: torch.Tensor          # bool
    b_pp_ok: torch.Tensor        # bool

    def replace(self, **changes) -> "Transcript":
        return dataclasses.replace(self, **changes)


def stack(objs: list):
    """A batch of instances' States (or Transcripts): each field stacked
    along a new leading axis, as ``jax.tree.map(jnp.stack, ...)`` batches
    the JAX package's pytrees for its vmap (``prover.prove_batch``,
    ``parallel/sharded.py``)."""
    return type(objs[0])(**{f.name: torch.stack([getattr(o, f.name)
                                                 for o in objs])
                            for f in dataclasses.fields(objs[0])})


def take(batch, b=None, device=None):
    """Instance b of a batch of States or Transcripts (an index; a slice
    gives a sub-batch; all of it when None), on ``device`` (where it lies
    when None)."""
    def one(x: torch.Tensor) -> torch.Tensor:
        x = x if b is None else x[b]
        return x if device is None else x.to(device)

    return type(batch)(**{f.name: one(getattr(batch, f.name))
                          for f in dataclasses.fields(batch)})


# every transcript message field but ``pi`` (as the JAX package's list)
TRANSCRIPT_FIELDS = ("u_1", "u_2", "t", "g", "h", "z", "c", "projection",
                     "psi", "omega", "b_prime_prime", "alpha", "beta")


def gram_hat(s_hat: torch.Tensor, plan) -> torch.Tensor:
    """G_ij = <s_i, s_j> in the eval domain: (P, r, n, d) -> (P, r, r, d)."""
    return ntt_ops.eval_matmul(s_hat, torch.swapaxes(s_hat, -3, -2), plan)


def state_from_constraints(a_k: torch.Tensor, phi_k: torch.Tensor,
                           witness: torch.Tensor,
                           params: LabradorParams) -> State:
    """State from constraint families (signed integers, |v| < q, lifted mod
    q), with b_k derived so `witness` satisfies each family (``gen_f``,
    ``structs.rs:320-341``)."""
    p = params
    plan = ntt_ops.plan_for(p)
    a_k = mod_pos(a_k.to(torch.int64), p.q)
    phi_k = mod_pos(phi_k.to(torch.int64), p.q)
    K = a_k.shape[0]
    P = plan.n_primes

    s_hat = ntt_ops.ntt_fwd(witness, plan)
    g = ntt_ops.ntt_inv_modq(gram_hat(s_hat, plan), plan)
    g_hat = ntt_ops.ntt_fwd(g, plan)
    a_hat = ntt_ops.ntt_fwd(a_k, plan)
    phi_hat = ntt_ops.ntt_fwd(phi_k, plan)
    term_a = ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(a_hat, g_hat[:, None], plan).reshape(P, K, -1, p.d),
        plan, axis=2)
    term_phi = ntt_ops._mod_sum_p(
        ntt_ops.eval_mul(phi_hat, s_hat[:, None], plan).reshape(P, K, -1,
                                                                p.d),
        plan, axis=2)
    b_k = ntt_ops.ntt_inv_modq(ntt_ops.eval_add(term_a, term_phi, plan), plan)
    return State(a_k=a_k, phi_k=phi_k, b_k=b_k, a_prime_k=a_k,
                 phi_prime_k=phi_k, b_prime_k=b_k[:, 0])


def generate_state(key: Key, witness: torch.Tensor,
                   params: LabradorParams) -> State:
    """Random constraint families satisfied by `witness` (``State::new``):
    symmetric a_k taking each (i, j) value from the i <= j slot."""
    p = params
    dev = witness.device
    ka, kphi = split(key)
    a_full = sampling.uniform_zq(ka, (p.k_count, p.r, p.r, p.d), p.q, dev)
    ii = torch.arange(p.r, device=dev)[:, None]
    jj = torch.arange(p.r, device=dev)[None, :]
    a_k = a_full[:, torch.minimum(ii, jj), torch.maximum(ii, jj), :]
    phi_k = sampling.uniform_zq(kphi, (p.k_count, p.r, p.n, p.d), p.q, dev)
    return state_from_constraints(a_k, phi_k, witness, p)


# ---------------------------------------------------------------------------
# Serialization / size metric (the JAX package's bincode writers)
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _i128_le(flat: np.ndarray) -> np.ndarray:
    """(N,) integers -> (N, 16) uint8 two's-complement i128 little endian."""
    v = flat.astype(np.int64).reshape(-1)
    out = np.zeros((v.size, 16), np.uint8)
    out[:, :8] = v.astype("<i8").view(np.uint8).reshape(-1, 8)
    out[:, 8:] = np.where(v < 0, np.uint8(0xFF), np.uint8(0))[:, None]
    return out


def _bincode_poly_vec(arr: np.ndarray, chunk_rows: int = 1 << 16):
    """Vec<Rq>: u64 count, then per element a u64 coefficient count and
    i128 coefficients (``algebraic.rs:422-429``), yielded in chunks."""
    flat = arr.reshape(-1, arr.shape[-1])
    n, d = flat.shape
    yield n.to_bytes(8, "little")
    pre = np.frombuffer(int(d).to_bytes(8, "little"), np.uint8)
    for s in range(0, n, chunk_rows):
        blk = flat[s:s + chunk_rows]
        rows = np.concatenate(
            [np.broadcast_to(pre, (len(blk), 8)),
             _i128_le(blk).reshape(len(blk), d * 16)], axis=1)
        yield rows.tobytes()


def _bincode_zq_vec(arr: np.ndarray, chunk: int = 1 << 22,
                    mod: int | None = None):
    """Vec<Zq>: u64 count, then i128 values; ``mod`` reduces each chunk
    (the int8 JL matrices, widened one chunk at a time)."""
    arr = arr.reshape(-1)
    yield len(arr).to_bytes(8, "little")
    for s in range(0, arr.size, chunk):
        blk = arr[s:s + chunk]
        if mod is not None:
            blk = blk.astype(np.int64) % mod
        yield _i128_le(blk).tobytes()


def bincode_chunks(tr: Transcript, q: int, fs: bool = False):
    """The transcript's bincode byte stream, in the reference's field order
    (``structs.rs:193-209``); ``fs=True`` drops the fields a Fiat-Shamir
    verifier re-derives (pi, psi, omega, alpha, beta, c)."""
    parts = [_bincode_poly_vec(_np(tr.u_1))]
    if not fs:
        parts.append(_bincode_zq_vec(_np(tr.pi), mod=q))
    parts.append(_bincode_zq_vec(_np(tr.projection)))
    if not fs:
        parts += [_bincode_zq_vec(_np(tr.psi)), _bincode_zq_vec(_np(tr.omega))]
    parts.append(_bincode_poly_vec(_np(tr.b_prime_prime)))
    if not fs:
        parts += [_bincode_poly_vec(_np(tr.alpha)),
                  _bincode_poly_vec(_np(tr.beta))]
    parts.append(_bincode_poly_vec(_np(tr.u_2)))
    if not fs:
        parts.append(_bincode_poly_vec(_np(tr.c)))
    parts += [_bincode_poly_vec(_np(tr.z)), _bincode_poly_vec(_np(tr.t)),
              _bincode_poly_vec(_np(tr.g)), _bincode_poly_vec(_np(tr.h))]
    for part in parts:
        yield from part


def transcript_size_in_bytes(tr: Transcript, q: int, fs: bool = False) -> int:
    """Compressed size of the bincode image (zlib level 9), matching
    ``Transcript::size_in_bytes`` (``structs.rs:212-221``)."""
    comp = zlib.compressobj(9)
    total = 0
    for blk in bincode_chunks(tr, q, fs):
        total += len(comp.compress(blk))
    return total + len(comp.flush())


def transcript_sha256(tr: Transcript, q: int, fs: bool = False) -> str:
    """SHA-256 hex digest of the uncompressed bincode stream."""
    h = hashlib.sha256()
    for blk in bincode_chunks(tr, q, fs):
        h.update(blk)
    return h.hexdigest()


# dtypes the JAX package's transcript arrays carry (int32 residues, int8
# JL matrices, bool flags), so saved files hold the same .npy members
_SAVE_DTYPES = {"pi": np.int8, "jl_ok": np.bool_, "b_pp_ok": np.bool_}
# fields that are not residues: at big q they stay one member (signed c)
_NOT_RESIDUES = ("pi", "c", "jl_ok", "b_pp_ok")


def save_transcript(tr: Transcript, path: str, q: int) -> None:
    """Persist a transcript as ``np.savez_compressed``, one member per field
    in declaration order with the JAX package's dtypes.  At a big modulus
    ``q`` each residue field is written as the JAX package writes its
    two-limb ``Zq2`` fields: members ``<name>__hi`` (value >> 16) and
    ``<name>__lo`` (the low 16 bits), int32.  Raises if a single-member
    field does not fit its dtype (a big-q transcript saved with a small
    ``q``)."""
    arrays = {}
    for f in dataclasses.fields(tr):
        v = _np(getattr(tr, f.name))
        if zq.is_big(q) and f.name not in _NOT_RESIDUES:
            arrays[f.name + "__hi"] = (v >> 16).astype(np.int32)
            arrays[f.name + "__lo"] = (v & 0xFFFF).astype(np.int32)
            continue
        a = v.astype(_SAVE_DTYPES.get(f.name, np.int32))
        if not np.array_equal(a, v):
            raise ValueError(f"field {f.name} does not fit {a.dtype} at "
                             f"q = {q}")
        arrays[f.name] = a
    np.savez_compressed(path, **arrays)


def load_transcript(path: str, device="cuda") -> Transcript:
    """Read a transcript that this package's or the JAX package's
    ``save_transcript`` wrote: a two-limb member pair ``<name>__hi`` /
    ``<name>__lo`` becomes one int64 residue (hi << 16) | lo; int8 and
    bool members keep their dtype, every other field becomes int64."""
    fields = {}
    with np.load(path) as z:
        for k in z.files:
            if k.endswith("__lo"):
                continue
            if k.endswith("__hi"):
                name = k[:-len("__hi")]
                a = (z[k].astype(np.int64) << 16) \
                    | z[name + "__lo"].astype(np.int64)
            else:
                name, a = k, z[k]
                if a.dtype not in (np.int8, np.bool_):
                    a = a.astype(np.int64)
            fields[name] = torch.from_numpy(a).to(device)
    return Transcript(**fields)
