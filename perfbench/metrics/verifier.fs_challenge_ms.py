"""verifier.fs_challenge_ms: ``verifier.fs_challenge_report`` (every
Fiat-Shamir challenge re-derived: the JL matrices' SHA-256 stream, the
transcript absorbs, the challenge draws), per verify, between device
syncs."""

PROBES = [{"target": "labrador_tpu_torch.verifier.fs_challenge_report",
           "span": "verifier.fs_challenge_report"}]


def read(rec):
    d = rec.spans.get("verifier.fs_challenge_report")
    return 1e3 * sum(d) / len(d) if d else None
