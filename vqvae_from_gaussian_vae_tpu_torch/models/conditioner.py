"""FLUX's text conditioners: ``HFEmbedder``.

Port of ``vqvae_from_gaussian_vae_tpu/models/conditioner.py`` (which serves
the reference's contract with the transformers Flax classes) on the
transformers torch classes: a CLIP text model gives its ``pooler_output``
vector, a T5 encoder its ``last_hidden_state`` sequence -- what
``FluxPipeline.__call__`` takes as ``inp_vec`` and ``inp_txt``.

A model (and a tokenizer) may be injected; ``embed_ids`` takes token ids, so
a tokenizer is optional.  ``version`` is a LOCAL checkpoint directory,
loaded with ``transformers`` imported at that call; nothing downloads.  Where
``transformers`` is not installed (the card's machine has no copy), that
call raises an ``ImportError`` saying so; an injected model needs no
``transformers`` here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class HFEmbedder:
    """``HFEmbedder(version, max_length)``; ``embedder(texts) -> tensor``."""

    def __init__(self, version: Optional[str] = None, max_length: int = 512,
                 is_clip: Optional[bool] = None, model=None, tokenizer=None, device=None,
                 **hf_kwargs):
        self.max_length = max_length
        if model is None:
            if version is None:
                raise ValueError("HFEmbedder needs a local checkpoint path or a model")
            try:
                from transformers import AutoConfig
            except ImportError as e:
                raise ImportError(
                    f"HFEmbedder({version!r}) loads a local checkpoint with the transformers "
                    "package, which is not installed here; pass model= (and tokenizer=) "
                    "instead") from e
            model_type = getattr(AutoConfig.from_pretrained(version), "model_type", "")
            if is_clip is None:
                is_clip = "clip" in model_type
            if is_clip:
                from transformers import CLIPTextModel, CLIPTokenizer

                model = CLIPTextModel.from_pretrained(version, **hf_kwargs)
                tokenizer = tokenizer or CLIPTokenizer.from_pretrained(version)
            else:
                from transformers import AutoTokenizer, T5EncoderModel

                model = T5EncoderModel.from_pretrained(version, **hf_kwargs)
                tokenizer = tokenizer or AutoTokenizer.from_pretrained(version)
        if is_clip is None:
            raise ValueError("pass is_clip when injecting a model")
        self.is_clip = bool(is_clip)
        self.output_key = "pooler_output" if self.is_clip else "last_hidden_state"
        self.model = model.eval()
        if device is not None:
            self.model.to(device)
        self.tokenizer = tokenizer

    @torch.inference_mode()
    def embed_ids(self, input_ids) -> torch.Tensor:
        """(B, L) token ids -> (B, D) pooled (CLIP) or (B, L, D) (T5): the
        frozen model on fixed-length padded ids, no attention mask, as the
        reference's forward."""
        device = next(self.model.parameters()).device
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=device)
        return getattr(self.model(input_ids=ids), self.output_key)

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError("no tokenizer available: use embed_ids(input_ids) instead")
        enc = self.tokenizer(list(texts), truncation=True, max_length=self.max_length,
                             padding="max_length", return_tensors="np")
        return self.embed_ids(enc["input_ids"])
