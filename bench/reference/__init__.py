"""Plain references, one module per backend (``reference/<backend>.py``),
and the divergences they share (``bregman.py``).

Each computes, from the run's own points and what it follows of the fitted
model, the answers of the served requests in float64, and the same in the
next precision below the configuration's float32 (its ``CONTROL``), the
control that a sound comparison has to fail.  Each defines::

    CONTROL: str
    checks(x, fitted, config) -> dict[str, float]     # the fit's own checks
    control_sigma_err(x, fitted, config) -> float     # the control's sigma_err
    answers(x, fitted, config, y0, alpha, n_iters, precision) -> (N, K) tensor

Every call gets the configuration, and works under the divergence that it
names (``config["fit"]["divergence"]``; ``bregman.py`` lists those
implemented and refuses the others).  They import neither ``jax``, nor
``repro``, nor anything of ``repro_torch``.
"""
