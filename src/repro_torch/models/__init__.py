"""The LM stack's dense transformers (``layers``, ``transformer``)."""
