"""Recipe stages: the one-to-one recipe's stages 1, a, 2, 3, 4, 5 and 6
(``recipe.run_stages``) and neural-vocoder synthesis."""
