"""Frozen copies: the yardstick's parts that came from the program's
repository, kept here so that no later change to the program moves them.
Each module names the file and commit it was copied from."""
