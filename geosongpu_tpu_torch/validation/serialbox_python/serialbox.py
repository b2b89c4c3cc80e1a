"""The read side of serialbox's Python module that the converter calls
(validation/serialbox_convert.py: `Serializer(OpenModeKind.Read, dir,
prefix)`, then `savepoint_list`, `fields_at_savepoint` and `read`), over
the binary on-disk layout of validation/serialbox_binary.py.  Imported as
the top-level module `serialbox` from SERIALBOX_PYTHON, as the converter
imports the real one."""
import enum

from geosongpu_tpu_torch.validation.serialbox_binary import \
    BinaryDatSerializer


class OpenModeKind(enum.Enum):
    Read = 0
    Write = 1
    Append = 2


def Serializer(mode, directory: str, prefix: str) -> BinaryDatSerializer:
    if mode is not OpenModeKind.Read:
        raise NotImplementedError("this serialbox reads only; write a dump "
                                  "with serialbox_binary.write_fixture")
    return BinaryDatSerializer(directory, prefix)
