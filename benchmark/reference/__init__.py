"""Plain references the benchmark holds the program's outputs against.

Each module here is named by a configuration's `reference` key and
imports nothing of the program under test: it is given the same input
images and works out every volume, window and map itself.
"""
