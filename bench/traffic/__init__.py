"""Traffic mixes: ``<mix>.json`` files of parameters, and one generator
module per kind of ``loop`` they name (``open.py``)."""
