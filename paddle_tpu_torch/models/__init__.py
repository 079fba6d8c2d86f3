"""Decoder-only language models of the port: the GPT family
(:mod:`.gpt`) and the Llama family (:mod:`.llama`), with the shared
decoder plumbing (:mod:`.lm_utils`) and KV-cache generation
(:mod:`.generation`)."""
