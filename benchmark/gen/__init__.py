"""Frozen generators: vocabulary, query text, the synthetic index and the
model weights, each drawn from a seed. They import nothing of the program,
so a change to the program never changes the inputs."""
