"""The benchmark's plain reference of the LaBRADOR prover and verifier.

A frozen copy of the plain PyTorch paths of ``labrador_tpu_torch`` (the
program under test) at the benchmark's first commit, cut to what the
benchmark's cells run: the Threefry CRS, the big modulus with exact
signed digits, one instance at a time, the interactive and the
Fiat-Shamir oracle.  It imports nothing of the program, of the JAX
package or of JAX, takes no kernel of the program, and hashes every
SHA-256 stream with ``hashlib``.  Later changes to the program do not
reach it: it is the yardstick that the program's proofs are held to, bit
for bit.  It also makes the statements that both sides are given
(``instance``).
"""
