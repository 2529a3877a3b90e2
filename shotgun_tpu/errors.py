"""Domain error marker for user-facing ValueErrors.

The reference CLI funnels ``ValueError`` to a clean ``sys.exit(err)``
(reference main.py:401) because its engine raises plain ValueError for
user-input problems (``similarity_threshold`` out of range,
kmer.py:115-117; negative ``m``, kmer.py:488-489).  Catching bare
ValueError at the CLI, however, also swallows genuine internal bugs
(a bad reshape, a shape mismatch) and presents them as clean user
errors.

``UserInputError`` subclasses ValueError so the public API surface is
unchanged (``pytest.raises(ValueError)`` and reference-parity message
checks still hold), while the CLI catches only this subclass -- an
unexpected internal ValueError now produces a traceback, as it should.
"""


class UserInputError(ValueError):
    """A ValueError that is part of the reference's user-facing contract."""
