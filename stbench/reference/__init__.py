"""Plain references the benchmark judges the program's outputs by. They
import nothing of the program nor of the JAX package."""
