"""Parameter derivation, single-sourced from the JAX-free
``labrador_tpu.params`` (importing ``labrador_tpu`` runs only that module)."""

from labrador_tpu.params import (  # noqa: F401  (re-exports)
    D,
    K_DEFAULT,
    L_DEFAULT,
    Q_START_DEFAULT,
    TAU,
    T_OPNORM,
    LabradorParams,
    _ceil_log,
    find_suitable_prime,
    select_crt_primes,
)
