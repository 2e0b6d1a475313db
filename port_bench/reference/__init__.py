"""The benchmark's plain reference: PyTorch in fp32 (TF32 off), with no
import of the program under test."""
