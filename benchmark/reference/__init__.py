"""The plain reference: the ColBERT query encoder (BERT, the linear head,
normalization, [MASK] augmentation) and the PLAID search funnel, in plain
PyTorch at float32 with TF32 off, written from the published description
and the port's documented semantics. It imports nothing of the program and
takes nothing the program made: the harness hands it the seed's weights,
the query text and the synthetic index arrays (``benchmark.registry``
checks its imports at the start of every run)."""
