"""The port's drives: ``python -m multi_modal_transformers_tokenmerge_torch.
examples.train_octo`` and ``... .examples.serve_octo``."""
