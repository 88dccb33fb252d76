"""The benchmark's own arithmetic: operation and byte counts, published
peaks, kernel groups and the reduction of a profiler trace. Later
versions of the program may change theirs; these stay as they are."""
