"""Command-line entry points of the port, one module per script of the JAX
package's ``examples/``, with the same arguments, options, defaults and
output, plus ``--device`` (default ``cuda``). Run each with
``python -m colbert_torch.examples.<name>``; each has a ``main(argv=None)``
that returns its result as well as printing it. Without a GPU they exit
non-zero unless given ``--device cpu``.
"""
