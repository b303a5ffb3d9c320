"""The quantized serving towers at octo_base's full width, on the CPU in
float32: the JAX package's towers and the port's, each against its own
float tower, on the same random weights (flax initializers, one seed) and
inputs.

    JAX_PLATFORMS=cpu python tests/quant_full_width.py

Prints, for the T5-base text tower (B=1, 16 tokens) and the image tower
(B=1, two 280x280 frames), the relative L2 error of the int8 and w8 towers'
output against the float tower's, in each package, and the largest
difference between the two packages' quantized outputs.  With random
weights the towers have no structure for post-training quantization to
keep, so these errors are far above the micro towers' of the JAX package's
tests; the port's should equal the JAX package's.  About a minute and 3 GB.
Not a test (pytest does not collect it).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent)]

from torch_parity import to_torch_config  # noqa: E402
from multi_modal_transformers_tokenmerge_torch import convert  # noqa: E402
from multi_modal_transformers_tokenmerge_torch.models.octo import (  # noqa: E402
    Octo as TOcto)
from multi_modal_transformers_tokenmerge_torch.serve import (  # noqa: E402
    quantize as tq)
from multi_modal_transformers_tokenmerge_tpu.models.octo import (  # noqa: E402
    Octo as JOcto)
from multi_modal_transformers_tokenmerge_tpu.models.presets import (  # noqa: E402
    octo_base)
from multi_modal_transformers_tokenmerge_tpu.serve import (  # noqa: E402
    quantize as jq)


def rel(a, ref):
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def main():
    cfg = octo_base(dtype="float32")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.text.vocab_size, (1, cfg.text.max_length))
    images = rng.integers(0, 256, (1, 2, *cfg.images.image_size)).astype(
        np.float32)
    jm = JOcto(cfg)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "diffusion": jax.random.PRNGKey(1)},
                jnp.asarray(ids, jnp.int32), jnp.asarray(images))
    params = jax.tree.map(np.asarray, v["params"])
    tc = to_torch_config(cfg)
    tm = TOcto(tc, device="cpu", seed=None).eval()
    tm.load_state_dict(convert.from_flax(params, tc))
    ids_t = torch.tensor(ids, dtype=torch.long)
    img_t = torch.tensor(images)
    t = cfg.text
    kw = dict(rel_pos_buckets=t.t5_rel_pos_buckets,
              rel_pos_max_distance=t.t5_rel_pos_max_distance)
    with torch.no_grad():
        text_j = np.asarray(jm.apply(v, jnp.asarray(ids), method="encode_text"))
        text_t = tm.encode_text(ids_t).numpy()
        img_j = np.asarray(jm.apply(
            v, jnp.asarray(images), False,
            method=lambda m, im, train: m.image_encoder(im, train)))
        img_t_f = tm.image_encoder(img_t).numpy()
        qt_j = jq.quantize_t5_params(params["text_encoder"]["t5_encoder"])
        qt_t = tq.quantize_t5_params(tm.text_encoder.t5_encoder)
        qi_j = jq.quantize_image_tower(jm, v)
        qi_t = tq.quantize_image_tower(tm)
        print(f"float towers, port against JAX: text max |diff| "
              f"{np.abs(text_t - text_j).max():.3e}, image "
              f"{np.abs(img_t_f - img_j).max():.3e}")
        for mode in ("int8", "w8"):
            a_j = np.asarray(jq.t5_encode_int8(qt_j, jnp.asarray(ids),
                                               dtype=jnp.float32, mode=mode,
                                               **kw))
            a_t = tq.t5_encode_int8(qt_t, ids_t, dtype=torch.float32,
                                    mode=mode, **kw).numpy()
            embed_j = jq.image_embed_int8 if mode == "int8" \
                else jq.image_embed_w8
            embed_t = tq.image_embed_int8 if mode == "int8" \
                else tq.image_embed_w8
            b_j = np.asarray(embed_j(qi_j, jnp.asarray(images), cfg.images,
                                     dtype=jnp.float32))
            b_t = embed_t(qi_t, img_t, tc.images, dtype=torch.float32).numpy()
            print(f"{mode}: text tower relative error JAX {rel(a_j, text_j):.4f}"
                  f", port {rel(a_t, text_t):.4f}, port against JAX "
                  f"{rel(a_t, a_j):.2e} (max |diff| "
                  f"{np.abs(a_t - a_j).max():.3e}); image tower JAX "
                  f"{rel(b_j, img_j):.4f}, port {rel(b_t, img_t_f):.4f}, port "
                  f"against JAX {rel(b_t, b_j):.2e} (max |diff| "
                  f"{np.abs(b_t - b_j).max():.3e})")


if __name__ == "__main__":
    main()
