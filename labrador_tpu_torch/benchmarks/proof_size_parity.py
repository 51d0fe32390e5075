"""Proof size against the reference's serialization, the counterpart of
``benchmarks/proof_size_parity.py``.

The reference reports proof size as ``gzip(bincode(Transcript))``
(``structs.rs:212-221``), which ``structs.transcript_size_in_bytes``
reproduces.  At the reference's ``main.rs`` demo config (n = r = 2, q =
8191) on the reference's own CRS (``MaterializedCRS.create_chacha`` with
base seed ``bytes(range(32))``), and with witness, state and verifier key
from ``keys.key(20240807)`` split in three (the JAX script's instance):

  * ``framework``: the port's proof, serialized by
    ``transcript_size_in_bytes``;
  * ``refsim``: the same transcript with every field the prover derives
    (t, g, u_1, projection, b'', h, u_2, z) replaced by the reference
    algorithm's (``utils/refsim.py``) for the same witness, state, CRS
    and challenges, through the same bincode and zlib.

Transcript parity holds field by field (``tests/test_torch_refsim.py``),
so ``delta_bytes`` is 0.  One JSON line on stdout, with the device's name
(and on a card its power limit).  From the root of the repository:

    python -m labrador_tpu_torch.benchmarks.proof_size_parity
    python -m labrador_tpu_torch.benchmarks.proof_size_parity --device cpu
"""

from __future__ import annotations

import argparse
import json

import torch

from labrador_tpu_torch.benchmarks.common import card, require_device

FIELDS = ("t", "g", "u_1", "projection", "b_prime_prime", "h", "u_2", "z")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    from labrador_tpu_torch import keys, prover, sampling, structs
    from labrador_tpu_torch.crs import MaterializedCRS
    from labrador_tpu_torch.params import LabradorParams
    from labrador_tpu_torch.utils import refsim

    p = LabradorParams(n=2, r=2)          # main.rs demo config, q = 8191
    crs = MaterializedCRS.create_chacha(p, bytes(range(32)), args.device)
    kw, ks, kv = keys.split(keys.key(20240807), 3)
    witness = sampling.generate_witness(kw, p, args.device)
    state = structs.generate_state(ks, witness, p)
    proof = prover.prove(p, witness, state, crs, kv)
    assert bool(proof.jl_ok) and bool(proof.b_pp_ok)
    size_fw = structs.transcript_size_in_bytes(proof, p.q)

    ref = refsim.ref_prove(p, witness, state, crs,
                           refsim.extract_challenges(proof))
    ref_tr = proof.replace(**{f: torch.from_numpy(ref[f]).to(args.device)
                              for f in FIELDS})
    size_ref = structs.transcript_size_in_bytes(ref_tr, p.q)
    row = {"config": {"n": p.n, "r": p.r, "q": p.q, "kappa": p.kappa},
           "framework_gzip_bincode_bytes": size_fw,
           "refsim_gzip_bincode_bytes": size_ref,
           "delta_bytes": size_fw - size_ref, "device": card(args.device)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
