# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: policy_v1.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fpolicy_v1.proto\x12\x1bmettagrid_tpu.sim.policy_v1\"\xbc\x01\n\x11\x41gentObservations\x12\x10\n\x08\x61gent_id\x18\x01 \x01(\x05\x12\x14\n\x0cobservations\x18\x02 \x01(\x0c\x12>\n\x0cvisible_talk\x18\x03 \x03(\x0b\x32(.mettagrid_tpu.sim.policy_v1.VisibleTalk\"?\n\x06\x46ormat\x12%\n!AGENT_OBSERVATIONS_FORMAT_UNKNOWN\x10\x00\x12\x0e\n\nTRIPLET_V1\x10\x01\"\x83\x01\n\x10\x42\x61tchStepRequest\x12\x12\n\nepisode_id\x18\x01 \x01(\t\x12\x0f\n\x07step_id\x18\x02 \x01(\x03\x12J\n\x12\x61gent_observations\x18\x03 \x03(\x0b\x32..mettagrid_tpu.sim.policy_v1.AgentObservations\"Z\n\x0c\x41gentActions\x12\x10\n\x08\x61gent_id\x18\x01 \x01(\x05\x12\x11\n\taction_id\x18\x02 \x03(\x05\x12\x11\n\ttalk_text\x18\x03 \x01(\t\x12\x12\n\ninfos_json\x18\x04 \x01(\t\"U\n\x11\x42\x61tchStepResponse\x12@\n\ragent_actions\x18\x01 \x03(\x0b\x32).mettagrid_tpu.sim.policy_v1.AgentActions\"\xed\x01\n\tGameRules\x12@\n\x08\x66\x65\x61tures\x18\x01 \x03(\x0b\x32..mettagrid_tpu.sim.policy_v1.GameRules.Feature\x12>\n\x07\x61\x63tions\x18\x02 \x03(\x0b\x32-.mettagrid_tpu.sim.policy_v1.GameRules.Action\x1a:\n\x07\x46\x65\x61ture\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x15\n\rnormalization\x18\x03 \x01(\x01\x1a\"\n\x06\x41\x63tion\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x0c\n\x04name\x18\x02 \x01(\t\"8\n\nTalkConfig\x12\x12\n\nmax_length\x18\x01 \x01(\x05\x12\x16\n\x0e\x63ooldown_steps\x18\x02 \x01(\x05\"`\n\x0bVisibleTalk\x12\x10\n\x08\x61gent_id\x18\x01 \x01(\x05\x12\x0b\n\x03row\x18\x02 \x01(\x05\x12\x0b\n\x03\x63ol\x18\x03 \x01(\x05\x12\x17\n\x0fremaining_steps\x18\x04 \x01(\x05\x12\x0c\n\x04text\x18\x05 \x01(\t\"\xa5\x02\n\x12PolicyEnvInterface\x12\x44\n\x0cobs_features\x18\x01 \x03(\x0b\x32..mettagrid_tpu.sim.policy_v1.GameRules.Feature\x12\x0c\n\x04tags\x18\x02 \x03(\t\x12\x14\n\x0c\x61\x63tion_names\x18\x03 \x03(\t\x12\x18\n\x10move_energy_cost\x18\x04 \x01(\x05\x12\x12\n\nnum_agents\x18\x05 \x01(\x05\x12\x19\n\x11observation_shape\x18\x06 \x03(\x05\x12\x12\n\nobs_height\x18\x07 \x01(\x05\x12\x11\n\tobs_width\x18\x08 \x01(\x05\x12\x35\n\x04talk\x18\t \x01(\x0b\x32\'.mettagrid_tpu.sim.policy_v1.TalkConfig\"\x95\x02\n\x14PreparePolicyRequest\x12\x12\n\nepisode_id\x18\x01 \x01(\t\x12:\n\ngame_rules\x18\x02 \x01(\x0b\x32&.mettagrid_tpu.sim.policy_v1.GameRules\x12\x11\n\tagent_ids\x18\x03 \x03(\x05\x12R\n\x13observations_format\x18\x04 \x01(\x0e\x32\x35.mettagrid_tpu.sim.policy_v1.AgentObservations.Format\x12\x46\n\renv_interface\x18\x05 \x01(\x0b\x32/.mettagrid_tpu.sim.policy_v1.PolicyEnvInterface\"\x17\n\x15PreparePolicyResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'policy_v1_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _AGENTOBSERVATIONS._serialized_start=49
  _AGENTOBSERVATIONS._serialized_end=237
  _AGENTOBSERVATIONS_FORMAT._serialized_start=174
  _AGENTOBSERVATIONS_FORMAT._serialized_end=237
  _BATCHSTEPREQUEST._serialized_start=240
  _BATCHSTEPREQUEST._serialized_end=371
  _AGENTACTIONS._serialized_start=373
  _AGENTACTIONS._serialized_end=463
  _BATCHSTEPRESPONSE._serialized_start=465
  _BATCHSTEPRESPONSE._serialized_end=550
  _GAMERULES._serialized_start=553
  _GAMERULES._serialized_end=790
  _GAMERULES_FEATURE._serialized_start=696
  _GAMERULES_FEATURE._serialized_end=754
  _GAMERULES_ACTION._serialized_start=756
  _GAMERULES_ACTION._serialized_end=790
  _TALKCONFIG._serialized_start=792
  _TALKCONFIG._serialized_end=848
  _VISIBLETALK._serialized_start=850
  _VISIBLETALK._serialized_end=946
  _POLICYENVINTERFACE._serialized_start=949
  _POLICYENVINTERFACE._serialized_end=1242
  _PREPAREPOLICYREQUEST._serialized_start=1245
  _PREPAREPOLICYREQUEST._serialized_end=1522
  _PREPAREPOLICYRESPONSE._serialized_start=1524
  _PREPAREPOLICYRESPONSE._serialized_end=1547
# @@protoc_insertion_point(module_scope)
