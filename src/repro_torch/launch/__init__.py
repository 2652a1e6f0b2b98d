"""The card's figures, a counted roofline of the port's steps, and the
dry run over every (arch, shape) cell: ``device.py``, ``roofline.py`` and
``dryrun.py``.  Counterpart of the JAX package's ``launch/``."""
