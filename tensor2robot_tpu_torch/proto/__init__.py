"""The ``T2RAssets`` schema (``t2r.proto``) and its hand-written codec."""
