from edl_tpu_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM"]
