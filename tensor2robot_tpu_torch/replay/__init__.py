"""The QT-Opt replay tier. So far it holds the CPU-scale critic
(``smoke.TinyQCriticModel``); the ring buffer, Bellman updater and host
loop come with ``ROADMAP.md``'s flagship items 6-8."""
