"""Multi-device proving and verification over a (dp, rows) mesh of
``torch.distributed`` ranks: the mesh (``mesh``), joining a job and local
worlds of processes (``multihost``), the collectives (``collectives``)
and the sharded prover and verifier (``sharded``)."""
