# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: raft.proto
"""Generated protocol buffer code.

Ports ``etcd_tpu/pb/raft_pb2.py``.
"""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nraft.proto\x12\x06raftpb\"S\n\x05\x45ntry\x12\x0c\n\x04Term\x18\x02 \x01(\x04\x12\r\n\x05Index\x18\x03 \x01(\x04\x12\x1f\n\x04Type\x18\x01 \x01(\x0e\x32\x11.raftpb.EntryType\x12\x0c\n\x04\x44\x61ta\x18\x04 \x01(\x0c\"V\n\x10SnapshotMetadata\x12%\n\nconf_state\x18\x01 \x01(\x0b\x32\x11.raftpb.ConfState\x12\r\n\x05index\x18\x02 \x01(\x04\x12\x0c\n\x04term\x18\x03 \x01(\x04\"D\n\x08Snapshot\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12*\n\x08metadata\x18\x02 \x01(\x0b\x32\x18.raftpb.SnapshotMetadata\"\xfd\x01\n\x07Message\x12!\n\x04type\x18\x01 \x01(\x0e\x32\x13.raftpb.MessageType\x12\n\n\x02to\x18\x02 \x01(\x04\x12\x0c\n\x04\x66rom\x18\x03 \x01(\x04\x12\x0c\n\x04term\x18\x04 \x01(\x04\x12\x0f\n\x07logTerm\x18\x05 \x01(\x04\x12\r\n\x05index\x18\x06 \x01(\x04\x12\x1e\n\x07\x65ntries\x18\x07 \x03(\x0b\x32\r.raftpb.Entry\x12\x0e\n\x06\x63ommit\x18\x08 \x01(\x04\x12\"\n\x08snapshot\x18\t \x01(\x0b\x32\x10.raftpb.Snapshot\x12\x0e\n\x06reject\x18\n \x01(\x08\x12\x12\n\nrejectHint\x18\x0b \x01(\x04\x12\x0f\n\x07\x63ontext\x18\x0c \x01(\x0c\"7\n\tHardState\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0c\n\x04vote\x18\x02 \x01(\x04\x12\x0e\n\x06\x63ommit\x18\x03 \x01(\x04\"q\n\tConfState\x12\x0e\n\x06voters\x18\x01 \x03(\x04\x12\x10\n\x08learners\x18\x02 \x03(\x04\x12\x17\n\x0fvoters_outgoing\x18\x03 \x03(\x04\x12\x15\n\rlearners_next\x18\x04 \x03(\x04\x12\x12\n\nauto_leave\x18\x05 \x01(\x08\"`\n\nConfChange\x12$\n\x04type\x18\x02 \x01(\x0e\x32\x16.raftpb.ConfChangeType\x12\x0f\n\x07node_id\x18\x03 \x01(\x04\x12\x0f\n\x07\x63ontext\x18\x04 \x01(\x0c\x12\n\n\x02id\x18\x01 \x01(\x04\"I\n\x10\x43onfChangeSingle\x12$\n\x04type\x18\x01 \x01(\x0e\x32\x16.raftpb.ConfChangeType\x12\x0f\n\x07node_id\x18\x02 \x01(\x04\"|\n\x0c\x43onfChangeV2\x12\x30\n\ntransition\x18\x01 \x01(\x0e\x32\x1c.raftpb.ConfChangeTransition\x12)\n\x07\x63hanges\x18\x02 \x03(\x0b\x32\x18.raftpb.ConfChangeSingle\x12\x0f\n\x07\x63ontext\x18\x03 \x01(\x0c*H\n\tEntryType\x12\x0f\n\x0b\x45ntryNormal\x10\x00\x12\x13\n\x0f\x45ntryConfChange\x10\x01\x12\x15\n\x11\x45ntryConfChangeV2\x10\x02*\xd3\x02\n\x0bMessageType\x12\n\n\x06MsgHup\x10\x00\x12\x0b\n\x07MsgBeat\x10\x01\x12\x0b\n\x07MsgProp\x10\x02\x12\n\n\x06MsgApp\x10\x03\x12\x0e\n\nMsgAppResp\x10\x04\x12\x0b\n\x07MsgVote\x10\x05\x12\x0f\n\x0bMsgVoteResp\x10\x06\x12\x0b\n\x07MsgSnap\x10\x07\x12\x10\n\x0cMsgHeartbeat\x10\x08\x12\x14\n\x10MsgHeartbeatResp\x10\t\x12\x12\n\x0eMsgUnreachable\x10\n\x12\x11\n\rMsgSnapStatus\x10\x0b\x12\x12\n\x0eMsgCheckQuorum\x10\x0c\x12\x15\n\x11MsgTransferLeader\x10\r\x12\x11\n\rMsgTimeoutNow\x10\x0e\x12\x10\n\x0cMsgReadIndex\x10\x0f\x12\x14\n\x10MsgReadIndexResp\x10\x10\x12\x0e\n\nMsgPreVote\x10\x11\x12\x12\n\x0eMsgPreVoteResp\x10\x12*\x82\x01\n\x14\x43onfChangeTransition\x12\x1c\n\x18\x43onfChangeTransitionAuto\x10\x00\x12%\n!ConfChangeTransitionJointImplicit\x10\x01\x12%\n!ConfChangeTransitionJointExplicit\x10\x02*y\n\x0e\x43onfChangeType\x12\x15\n\x11\x43onfChangeAddNode\x10\x00\x12\x18\n\x14\x43onfChangeRemoveNode\x10\x01\x12\x18\n\x14\x43onfChangeUpdateNode\x10\x02\x12\x1c\n\x18\x43onfChangeAddLearnerNode\x10\x03')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'raft_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRYTYPE._serialized_start=992
  _ENTRYTYPE._serialized_end=1064
  _MESSAGETYPE._serialized_start=1067
  _MESSAGETYPE._serialized_end=1406
  _CONFCHANGETRANSITION._serialized_start=1409
  _CONFCHANGETRANSITION._serialized_end=1539
  _CONFCHANGETYPE._serialized_start=1541
  _CONFCHANGETYPE._serialized_end=1662
  _ENTRY._serialized_start=22
  _ENTRY._serialized_end=105
  _SNAPSHOTMETADATA._serialized_start=107
  _SNAPSHOTMETADATA._serialized_end=193
  _SNAPSHOT._serialized_start=195
  _SNAPSHOT._serialized_end=263
  _MESSAGE._serialized_start=266
  _MESSAGE._serialized_end=519
  _HARDSTATE._serialized_start=521
  _HARDSTATE._serialized_end=576
  _CONFSTATE._serialized_start=578
  _CONFSTATE._serialized_end=691
  _CONFCHANGE._serialized_start=693
  _CONFCHANGE._serialized_end=789
  _CONFCHANGESINGLE._serialized_start=791
  _CONFCHANGESINGLE._serialized_end=864
  _CONFCHANGEV2._serialized_start=866
  _CONFCHANGEV2._serialized_end=990
# @@protoc_insertion_point(module_scope)
