# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: control.proto
# A copy of shockwave_tpu/runtime/proto/control_pb2.py with a
# byte-identical serialized FileDescriptorProto: the same file name
# (control.proto) and proto package (shockwave_tpu), which is the wire
# name of every RPC, so the port's daemons and trainers talk to the
# unchanged scheduler. Identical bytes also let both modules register in
# protobuf's default pool in one process. See control.proto.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rcontrol.proto\x12\rshockwave_tpu"\x07\n\x05Empty"^\n\x15RegisterWorkerRequest\x12\x13\n\x0bworker_type\x18\x01 \x01(\t\x12\x0f\n\x07ip_addr\x18\x02 \x01(\t\x12\x0c\n\x04port\x18\x03 \x01(\x05\x12\x11\n\tnum_chips\x18\x04 \x01(\x05"l\n\x16RegisterWorkerResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x12\n\nworker_ids\x18\x02 \x03(\x05\x12\x16\n\x0eround_duration\x18\x03 \x01(\x01\x12\x15\n\rerror_message\x18\x04 \x01(\t"t\n\x0bDoneRequest\x12\x0f\n\x07job_ids\x18\x01 \x03(\x05\x12\x11\n\tworker_id\x18\x02 \x01(\x05\x12\x11\n\tnum_steps\x18\x03 \x03(\x03\x12\x17\n\x0fexecution_times\x18\x04 \x03(\x01\x12\x15\n\riterator_logs\x18\x05 \x03(\t"\x9c\x01\n\x0eJobDescription\x12\x0e\n\x06job_id\x18\x01 \x01(\x05\x12\x0f\n\x07command\x18\x02 \x01(\t\x12\x19\n\x11working_directory\x18\x03 \x01(\t\x12\x16\n\x0eneeds_data_dir\x18\x04 \x01(\x08\x12\x15\n\rnum_steps_arg\x18\x05 \x01(\t\x12\x11\n\tnum_steps\x18\x06 \x01(\x03\x12\x0c\n\x04mode\x18\x07 \x01(\t"a\n\rRunJobRequest\x12+\n\x04jobs\x18\x01 \x03(\x0b2\x1d.shockwave_tpu.JobDescription\x12\x11\n\tworker_id\x18\x02 \x01(\x05\x12\x10\n\x08round_id\x18\x03 \x01(\x05" \n\x0eKillJobRequest\x12\x0e\n\x06job_id\x18\x01 \x01(\x05"3\n\x0eInitJobRequest\x12\x0e\n\x06job_id\x18\x01 \x01(\x05\x12\x11\n\tworker_id\x18\x02 \x01(\x05"N\n\x0fInitJobResponse\x12\x11\n\tmax_steps\x18\x01 \x01(\x03\x12\x14\n\x0cmax_duration\x18\x02 \x01(\x01\x12\x12\n\nextra_time\x18\x03 \x01(\x01"\xac\x01\n\x12UpdateLeaseRequest\x12\x0e\n\x06job_id\x18\x01 \x01(\x05\x12\x11\n\tworker_id\x18\x02 \x01(\x05\x12\r\n\x05steps\x18\x03 \x01(\x03\x12\x10\n\x08duration\x18\x04 \x01(\x01\x12\x11\n\tmax_steps\x18\x05 \x01(\x03\x12\x14\n\x0cmax_duration\x18\x06 \x01(\x01\x12)\n\x10measured_reports\x18\x07 \x03(\tR\x0fmeasuredReports"i\n\x13UpdateLeaseResponse\x12\x11\n\tmax_steps\x18\x01 \x01(\x03\x12\x14\n\x0cmax_duration\x18\x02 \x01(\x01\x12\x17\n\x0frun_time_so_far\x18\x03 \x01(\x01\x12\x10\n\x08deadline\x18\x04 \x01(\x01"g\n UpdateResourceRequirementRequest\x12\x0e\n\x06job_id\x18\x01 \x01(\x05\x12\x11\n\tworker_id\x18\x02 \x01(\x05\x12\x0e\n\x06big_bs\x18\x03 \x01(\x08\x12\x10\n\x08small_bs\x18\x04 \x01(\x08b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'control_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
# @@protoc_insertion_point(module_scope)
