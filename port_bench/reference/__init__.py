"""The plain reference: the DRN's forward, grading and stage-1 step in
plain PyTorch, fp32 with TF32 off. It imports nothing of the program and
takes nothing the program made: the benchmark hands it the same weights,
tables and batches it hands the program."""
