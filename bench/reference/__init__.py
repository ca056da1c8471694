"""Plain PyTorch references the benchmark judges the program against.  They
import nothing of the program and take nothing it made."""
