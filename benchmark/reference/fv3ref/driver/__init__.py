"""Part of the frozen plain-path copy (see ``fv3ref/__init__.py``)."""
