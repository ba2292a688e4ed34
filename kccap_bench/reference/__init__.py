"""The plain reference the benchmark holds the program's answers to.

It reads the generated fixture and event stream and nothing the program
made, and imports neither JAX nor any module of the program.
"""
