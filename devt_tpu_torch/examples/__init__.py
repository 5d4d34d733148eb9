"""The five example journeys of ``examples/*.py`` on the port, each a
module with ``main(argv=None, device=None)`` (the card unless the caller
passes ``device="cpu"``), runnable as
``python -m devt_tpu_torch.examples.<name>``.  Extra ``--key value``
arguments of the training journeys go to ``devt_tpu_torch.main`` after
the example's own, so they override them."""
