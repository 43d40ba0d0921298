"""``python -m cyclevae_tpu_torch --stage 1a23456 --work DIR --wav-root DIR``:
the one-to-one recipe (:func:`cyclevae_tpu_torch.pipeline.recipe.main`), on
the current CUDA device unless ``--device cpu`` is passed."""

from .pipeline.recipe import main

if __name__ == "__main__":
    main()
