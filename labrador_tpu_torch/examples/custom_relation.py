"""Example: prove YOUR OWN dot-product relation (not the random demo one).

The counterpart of ``examples/custom_relation.py``.  The principal
relation (LaBRADOR §3) over witness vectors s_1..s_r of ring elements is

    f(s) = sum_ij a_ij <s_i, s_j> + sum_i <phi_i, s_i> - b = 0 .

You supply a_k (quadratic coefficients) and phi_k (linear coefficients);
``structs.state_from_constraints`` derives b so the relation holds for
your witness, and the standard pipeline proves and verifies it
(Fiat-Shamir: ``prove_fs`` / ``verify_fs``).

Run from the root of the repository, on the card (the default) or on the
CPU:

    python -m labrador_tpu_torch.examples.custom_relation
    python -m labrador_tpu_torch.examples.custom_relation --device cpu
"""

from __future__ import annotations

import argparse

import torch

from labrador_tpu_torch import prover, structs, verifier
from labrador_tpu_torch.crs import CRS
from labrador_tpu_torch.params import LabradorParams


def main(device="cuda") -> bool:
    p = LabradorParams(n=4, r=2, kappa_override=32)
    d, q = p.d, p.q

    # --- your secret witness: r vectors of n ring elements each.
    # Keep its norm within beta (= params.beta_bound): binary coefficients
    # give norm^2 <= r*n*d = 512 < beta^2 = 961 here.
    gen = torch.Generator().manual_seed(0)
    witness = torch.randint(0, 2, (p.r, p.n, d), generator=gen).to(device)

    # --- your relation: here, one family asserting
    #     <s_0, s_1> + <phi_0, s_0> = b     (a_01 = a_10 = 1, phi_0 = j)
    a_k = torch.zeros((1, p.r, p.r, d), dtype=torch.int64, device=device)
    a_k[0, 0, 1, 0] = a_k[0, 1, 0, 0] = 1                 # symmetric
    phi_k = torch.zeros((1, p.r, p.n, d), dtype=torch.int64, device=device)
    phi_k[0, 0, :, 0] = torch.arange(p.n) % q

    state = structs.state_from_constraints(a_k, phi_k, witness, p)
    print(f"relation target b(0) = {int(state.b_prime_k[0])}")

    # --- prove + verify (non-interactive)
    crs = CRS.create(p, seed=0xD07)
    proof = prover.prove_fs(p, witness, state, crs)
    assert bool(proof.jl_ok) and bool(proof.b_pp_ok)
    ok = verifier.verify_fs(p, state, proof, crs)
    size = structs.transcript_size_in_bytes(proof, q)
    print(f"verified: {ok}; proof size: {size / 1024:.1f} KB")
    assert ok
    return ok


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
