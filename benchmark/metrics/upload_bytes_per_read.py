"""Copies: bytes the entry uploads a read: whatever arrays the port's
packer (`ops.pack.pack_reads_2bit`) returns for a group, and its lengths,
over the group's reads."""


def read(ctx):
    return ctx.upload_bytes_per_group / ctx.reads_per_group
