"""The tools users run on the port, each as
``python -m quantum_resistant_p2p_tpu_torch.tools.<name>``.

Counterparts of the repo's ``tools/`` scripts for the JAX package:

* :mod:`.swarm_bench`   — BASELINE.json config 5, N peers handshaking with
                          one hub over localhost TCP; ``--slo`` (the
                          single-handshake probe), ``--storm`` (sustained
                          sessions through one in-process hub) and
                          ``--storm --fleet N`` (through gateway processes).
* :mod:`.compat_matrix` — every KEM x AEAD x signature combination through
                          two full node stacks.
* :mod:`.slo_merge`     — N gateways' ``slo_report.json`` into one fleet
                          report.
* :mod:`.trace_merge`   — N nodes' span dumps into one chrome://tracing
                          document.
* :mod:`.qrtop`         — a terminal dashboard over the gateways' and
                          routers' telemetry endpoints.

Their artifacts go to ``torch_results/`` unless told otherwise.
"""
