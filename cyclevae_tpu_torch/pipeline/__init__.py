"""Recipe stages: the one-to-one recipe's stages 1, a, 2, 3, 4, 5, 6, i and v
(``recipe.run_stages``), the many-to-many recipe's 3m-6m
(``recipe_mult.run_mult_stages``), the classifier and VQ-CycleVAE
trainers, and neural-vocoder synthesis."""
