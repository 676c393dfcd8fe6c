def encoder_module(cfg):
    """The model module of a speech encoder's config: models/parakeet for a
    ParakeetConfig, models/w2v_bert for a W2VBertConfig, models/wavlm for a
    WavLMConfig.  Each gives param_shapes, init_params, encode and
    batch_fn_for under the same names."""
    from stutter_tpu_torch.config import ParakeetConfig, W2VBertConfig

    if isinstance(cfg, ParakeetConfig):
        from stutter_tpu_torch.models import parakeet

        return parakeet
    if isinstance(cfg, W2VBertConfig):
        from stutter_tpu_torch.models import w2v_bert

        return w2v_bert
    from stutter_tpu_torch.models import wavlm

    return wavlm
