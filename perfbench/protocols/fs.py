"""The Fiat-Shamir proof: ``prover.prove_fs`` on the step's statement,
then ``verifier.verify_fs`` of its proof (a bool verdict), both with the
exact digits that the program's CLI takes at big q."""

from perfbench.lib.proofs import SingleProof
from perfbench.reference import prover as ref_prover
from perfbench.reference import verifier as ref_verifier

DECOMP = "exact"


class FiatShamir(SingleProof):

    def prove(self, step: int):
        from labrador_tpu_torch import prover
        i = self.statement(step)
        return prover.prove_fs(self.params, self.pool.witnesses[i],
                               self.states[i], self.crs, DECOMP)

    def verify(self, step: int, proof, timer=None):
        from labrador_tpu_torch import verifier
        return verifier.verify_fs(self.params,
                                  self.states[self.statement(step)], proof,
                                  self.crs, decomp_mode=DECOMP, timer=timer)

    def reference_prove(self, step: int):
        i = self.statement(step)
        return ref_prover.prove_fs(self.ref_params, self.pool.witnesses[i],
                                   self.pool.states[i], self.pool.crs)

    def reference_verify(self, step: int, proof):
        return ref_verifier.verify_fs(
            self.ref_params, self.pool.states[self.statement(step)],
            self.reference_transcript(proof), self.pool.crs)


make = FiatShamir
