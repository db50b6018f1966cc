"""Drop-in compatibility namespace for the reference package layout.

Every public module path from iosefa/obia resolves here to the JAX
implementation in :mod:`obia_tpu` (SURVEY.md §7 'Public API to preserve'),
so reference users can switch without changing imports:

    from obia.segmentation.segment import segment
    from obia.classification.classify import classify
"""
__version__ = "0.1.0"
