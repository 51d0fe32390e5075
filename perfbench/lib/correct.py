"""The comparison that decides ``correct``.

Once the window has closed, the reference (``perfbench/reference``)
recomputes each proof of the sample that the seed drew from the window,
from the same statement and keys, and judges the program's outputs:

* ``fields_differing``: transcript fields of the sampled proofs that are
  not bit-equal to the reference's (t and u_1 of phase 1; pi and the
  projection of phase 2a; psi, omega, b'', alpha, beta, h and u_2 of
  phase 2b; c and z of phase 3; the two self-check flags);
* ``bincode_differing``: 1 if the program's bincode image of the first
  sampled proof, without the fields a Fiat-Shamir verifier re-derives,
  differs from the reference's in length or in any byte (by SHA-256),
  else 0: the proof's size, byte for byte;
* ``verdicts_differing``: sampled steps whose window verdict (the whole
  report, for ``verify_report``) differs from the reference verifier's on
  the program's proof;
* ``tampered_verdicts_differing``: the first sampled proof tampered
  (the protocol's ``tampered``: u_1[0, 0] raised by one), judged by both
  verifiers: 1 if they differ;
* ``rejections_differing``: window steps that raised, and window steps
  whose verdict rejected the proof where the reference does not make the
  same proof and the same verdict on it (a rejected step whose proof the
  window did not keep counts; steps that repeat a kept proof are judged
  with it).  An honest proof of a true statement can fail check 14's
  ||z||^2 <= 2 gamma by chance, about once in 6,000 proofs, and then the
  reference rejects it too.  The reference is a copy of the program's
  plain paths, so its agreement alone does not show the proof honest:
  PERF.md section 7 gives the independent witness (z against a schoolbook
  sum of c_i s_i) for the one such proof seen.

The arithmetic is exact integers mod q, so every limit is 0.
"""

from __future__ import annotations

import time

LIMITS = {
    "fields_differing": 0,
    "bincode_differing": 0,
    "verdicts_differing": 0,
    "tampered_verdicts_differing": 0,
    "rejections_differing": 0,
}



def compare(traffic, sample: list, rejected: list, errors: int,
            seconds: dict | None = None) -> dict:
    """{number: value}, each to be held to ``LIMITS``.  ``sample`` and
    ``rejected`` list (step, proof, answer) of the window's sampled and
    rejected steps, ``errors`` counts its steps that raised; ``seconds``,
    if given, collects the time of each part of the check."""
    out = dict.fromkeys(LIMITS, 0)
    out["rejections_differing"] = errors
    seconds = {} if seconds is None else seconds

    def timed(part, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[part] = seconds.get(part, 0.0) \
                + time.perf_counter() - t0

    for k, (step, proof, answer) in enumerate(sample):
        ref = timed("reference_prove", traffic.reference_prove, step)
        out["fields_differing"] += len(traffic.differing(proof, ref))
        if timed("reference_verify", traffic.reference_verify, step,
                 proof) != answer:
            out["verdicts_differing"] += 1
        if k == 0:
            out["bincode_differing"] = int(
                timed("bincode", traffic.bincode, proof)
                != timed("bincode", traffic.reference_bincode, ref))
            bad = traffic.tampered(proof)
            out["tampered_verdicts_differing"] = int(
                timed("tampered", traffic.verify, step, bad)
                != timed("tampered", traffic.reference_verify, step, bad))
        del ref
    judged: dict = {}           # id of a kept proof: whether it differs
    for step, proof, answer in rejected:
        if proof is None:       # beyond the proofs the window kept
            out["rejections_differing"] += 1
            continue
        if id(proof) not in judged:
            ref = timed("rejected", traffic.reference_prove, step)
            judged[id(proof)] = bool(traffic.differing(proof, ref)) or timed(
                "rejected", traffic.reference_verify, step, proof) != answer
            del ref
        out["rejections_differing"] += judged[id(proof)]
    return out


def within(values: dict) -> bool:
    return all(values[k] <= LIMITS[k] for k in LIMITS)


def lines(values: dict) -> list[str]:
    return [f"check {k} {values[k]} limit {LIMITS[k]}" for k in LIMITS]
