"""The plain reference: NumPy and plain PyTorch, independent of the port.

Nothing here imports the port. Each CPD family has its check,
``reference/<family>.py`` with ``judge`` (found by the family's name):
``categorical_table`` refits the CPTs from the rows the benchmark made
(``fit.py``) and answers each row exactly by variable elimination, with
the likelihood-weighting variance beside each answer (``ve.py``); ``kde``
refits the KDE network from the same rows and runs plain likelihood
weighting over it (``kde_lw.py``). ``cat_lw.py`` and ``kde_lw.py`` are
also the controls that stand in the program's place with fewer
particles.
"""
