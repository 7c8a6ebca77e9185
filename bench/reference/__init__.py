"""Plain references, one module per backend (``reference/<backend>.py``).

Each computes, from the run's own points and what it follows of the fitted
model, the answers of the served requests in float64, and the same in the
next precision below the configuration's float32 (its ``CONTROL``), the
control that a sound comparison has to fail.  Each defines::

    CONTROL: str
    checks(x, fitted, config) -> dict[str, float]   # the fit's own checks
    control_sigma_err(x, fitted) -> float           # the control's sigma_err
    answers(x, fitted, y0, alpha, n_iters, precision) -> (N, K) tensor

They import neither ``jax``, nor ``repro``, nor anything of ``repro_torch``.
"""
