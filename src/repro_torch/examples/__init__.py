"""Runnable PAL examples on the port (twins of the reference's
``examples/quickstart.py`` and ``examples/potential_md.py``):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.potential_md [--device cpu]
"""
