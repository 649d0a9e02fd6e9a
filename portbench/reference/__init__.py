"""The plain reference: a Raft group in plain Python, written from
etcd's raft and independent of the program (raft.py); check.py holds the
program's sampled groups against it."""
