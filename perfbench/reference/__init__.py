"""Plain float32 references of the benchmark's model families, which the
comparison that decides ``correct`` holds the program to.  They import
nothing of the program and take nothing it made."""
