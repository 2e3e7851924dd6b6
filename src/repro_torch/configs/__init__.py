"""Architecture configs ported so far (``repro/configs``)."""
