from llamago_tpu_torch.eval.perplexity import perplexity  # noqa: F401
