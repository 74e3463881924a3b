"""Seconds of the program's fixture: the device instance over the batch,
its generators and its fixed-base tables (`models.u64_fixture`, or
`WNLADevice` with `fixed_base.build_tables`)."""


def read(m):
    return m.get("fixture_s")
