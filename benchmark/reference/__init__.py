"""The plain reference the benchmark judges the program by: plain PyTorch in
float32 with TF32 off, importing nothing of the program under test."""
