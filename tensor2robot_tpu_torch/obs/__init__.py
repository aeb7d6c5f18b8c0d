"""Observability: the training-health sentinel (``health``). The metric
registry, traces, ledger, flight recorder and watchdog of the JAX
package's ``obs`` tier wait for ``ROADMAP.md``'s flagship item 15."""
