"""The plain reference: NumPy and plain PyTorch, nothing of the program.

It works out again what the program derives from the benchmark's inputs
(the calibration's node losses, the support, the Markov chain, the line
DP tables, every stop and serve decision, every logit) and judges the
program's served tokens against it.
"""
