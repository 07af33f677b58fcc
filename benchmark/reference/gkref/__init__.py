"""A frozen copy of the JAX package's pure-Python policy engines.

Copied from ``gatekeeper_tpu`` at commit df605b0 (``lang/rego``,
``lang/cel``, ``drivers/{base,rego_driver,cel_driver}.py``,
``client/{client,types}.py``, ``target/``, ``match/``, ``apis/`` and
``utils/unstructured.py``), with each ``gatekeeper_tpu.`` import renamed to
``gkref.`` and the ``external_data`` builtin cut to a raise: the
benchmark's configurations load no external data provider.  These are the
interpreters the repository's tests hold both packages against; nothing here
imports JAX, the JAX package or the PyTorch port, and later changes to
either package do not reach this copy.
"""
