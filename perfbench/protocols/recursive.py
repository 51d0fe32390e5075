"""One level of recursion: ``prover.prove_recursive`` on the step's
statement with step k's verifier key (``Pool.verifier_key``): the base
proof, its fold at the configuration's ``fold`` (mu digit-stream
vectors, commitment rank kappa'), the folded proof; then
``verifier.verify_recursive`` of the recursive proof, which holds no base
opening (a report, its verdict under 'all').  The reference is
``reference/recursion``.  A program without ``prove_recursive`` is
refused at set-up."""

import dataclasses

from perfbench.lib.proofs import SingleProof, differing_fields, digest, fields
from perfbench.reference import recursion as ref_recursion
from perfbench.reference import structs as ref_structs


class Recursive(SingleProof):

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from labrador_tpu_torch import prover, recursion
        if not hasattr(prover, "prove_recursive"):
            raise RuntimeError("the program has no prover.prove_recursive")
        fold = config["fold"]
        if fold["levels"] != 1:
            raise ValueError(f"one level of recursion, not {fold['levels']}")
        self.mu, self.kappa_new = int(fold["mu"]), int(fold["kappa_new"])
        super().__init__(config, mix, seed, device)
        for side, lay in (
                ("program", recursion.make_layout(self.params, self.mu)),
                ("reference", ref_recursion.make_layout(self.ref_params,
                                                        self.mu))):
            got = {"n": lay.n_new, "r": lay.r_new, "k_count": lay.k_new,
                   "kappa": self.kappa_new}
            bad = {k: (v, got[k]) for k, v in
                   config.get("derived_folded", {}).items() if got[k] != v}
            if bad:
                raise ValueError(f"the {side} folds to {bad}, not the "
                                 f"configuration's values")

    def prove(self, step: int):
        from labrador_tpu_torch import keys, prover
        i = self.statement(step)
        vk = self.pool.verifier_key(step)
        return prover.prove_recursive(self.params, self.pool.witnesses[i],
                                      self.states[i], self.crs,
                                      keys.Key(vk.k0, vk.k1), self.mu,
                                      self.kappa_new)

    def verify(self, step: int, proof, timer=None):
        from labrador_tpu_torch import verifier
        return verifier.verify_recursive(
            self.params, self.states[self.statement(step)], proof, self.crs,
            self.mu, self.kappa_new, timer=timer)

    def reference_prove(self, step: int):
        i = self.statement(step)
        return ref_recursion.prove_recursive(
            self.ref_params, self.pool.witnesses[i], self.pool.states[i],
            self.pool.crs, self.pool.verifier_key(step), self.mu,
            self.kappa_new)

    def reference_verify(self, step: int, proof):
        return ref_recursion.verify_recursive(
            self.ref_params, self.pool.states[self.statement(step)],
            self.reference_transcript(proof), self.pool.crs, self.mu,
            self.kappa_new)

    def bincode(self, proof) -> tuple[int, str]:
        """Length and SHA-256 of the program's bincode image of the
        recursive proof without the fields a Fiat-Shamir verifier
        re-derives."""
        return digest(proof.bincode_chunks(self.params.q, fs=True))

    def reference_bincode(self, proof) -> tuple[int, str]:
        return digest(ref_recursion.bincode_chunks(
            self.reference_transcript(proof), self.ref_params.q, fs=True))

    @staticmethod
    def reference_transcript(proof):
        return ref_recursion.RecursiveProof(
            ref_structs.Transcript(**fields(proof.base)),
            int(proof.beta_new),
            ref_structs.Transcript(**fields(proof.folded)))

    @staticmethod
    def differing(proof, ref) -> list[str]:
        out = ["base." + f for f in differing_fields(proof.base, ref.base)]
        if int(proof.beta_new) != int(ref.beta_new):
            out.append("beta_new")
        return out + ["folded." + f
                      for f in differing_fields(proof.folded, ref.folded)]

    def tampered(self, proof):
        """The recursive proof with the folded u_1[0, 0] raised by one."""
        u_1 = proof.folded.u_1.clone()
        u_1[0, 0] = (u_1[0, 0] + 1) % self.params.q
        return dataclasses.replace(
            proof, folded=dataclasses.replace(proof.folded, u_1=u_1))


make = Recursive
