"""The reference's own interactive proof: ``prover.prove`` on the step's
statement with step k's verifier key (``Pool.verifier_key``), then
``verifier.verify_report`` of its proof (a report of every check, its
verdict under 'all'), both with the exact digits that the program's CLI
takes at big q."""

from perfbench.lib.proofs import SingleProof
from perfbench.reference import prover as ref_prover
from perfbench.reference import verifier as ref_verifier

DECOMP = "exact"


class Interactive(SingleProof):

    def prove(self, step: int):
        from labrador_tpu_torch import keys, prover
        i = self.statement(step)
        vk = self.pool.verifier_key(step)
        return prover.prove(self.params, self.pool.witnesses[i],
                            self.states[i], self.crs,
                            keys.Key(vk.k0, vk.k1), DECOMP)

    def verify(self, step: int, proof, timer=None):
        from labrador_tpu_torch import verifier
        return verifier.verify_report(self.params,
                                      self.states[self.statement(step)],
                                      proof, self.crs, DECOMP, timer=timer)

    def reference_prove(self, step: int):
        i = self.statement(step)
        return ref_prover.prove(self.ref_params, self.pool.witnesses[i],
                                self.pool.states[i], self.pool.crs,
                                self.pool.verifier_key(step))

    def reference_verify(self, step: int, proof):
        return ref_verifier.verify_report(
            self.ref_params, self.pool.states[self.statement(step)],
            self.reference_transcript(proof), self.pool.crs)


make = Interactive
